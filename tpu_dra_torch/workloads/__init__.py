"""Workloads of the port: the flagship TransformerLM and the hand-written
CUDA flash-attention kernels that carry its attention."""
