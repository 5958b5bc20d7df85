"""Entry point of the port (counterpart of __graft_entry__.entry()): the
flagship model's forward and its arguments at the default ModelConfig."""

from __future__ import annotations

import numpy as np
import torch

from tpu_dra_torch.workloads.model import (
    ModelConfig, TransformerLM, init_params, resolve_device,
)


def entry(device="cuda"):
    """(fn, args) with fn(*args) -> logits. fn is the TransformerLM
    module (it holds its parameters, drawn from seed 0); args are the
    reference's tokens (numpy RandomState(0), shape [2, max_seq])."""
    device = resolve_device(device)
    cfg = ModelConfig()
    model = TransformerLM(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), device))
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab, (2, cfg.max_seq)),
        dtype=torch.long, device=device)
    return model, (tokens,)
