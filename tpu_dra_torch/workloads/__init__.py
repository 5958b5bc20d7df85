"""Workloads of the port: the flagship TransformerLM (one GPU or a DP x TP
mesh), the MoE LM, the multi-GPU workload library (all-reduce, ring and
Ulysses attention, sequence-parallel training, MoE, the pipeline) over
torch.distributed, and the hand-written CUDA flash-attention kernels that
carry their attention."""
