"""PyTorch/CUDA port of the tpu_dra workload path, for NVIDIA Hopper GPUs.

The JAX package ``tpu_dra`` is the reference this package is held
against; this package imports nothing of it (and never imports JAX). It
keeps the reference's module names so each counterpart is easy to find:
``tpu_dra_torch.workloads.flashattention`` mirrors
``tpu_dra.workloads.flashattention`` and so on. Entry points take an
explicit ``device=`` that defaults to ``"cuda"`` and raise where no card
is present; tests pass ``device="cpu"``.
"""
