"""Plain attention for correctness checks (counterpart of
tpu_dra/workloads/ringattention.py). The ring itself — P2P sequence
sharding with the lse merge over flash_attention_with_lse — is a later
slice of the port; this module holds only what the attention dispatch
needs now."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Unsharded attention, q/k/v [B, S, H, D]. Scores are formed and
    scaled in the input dtype, then softmaxed in fp32, as the JAX
    reference does."""
    d = q.shape[-1]
    scores = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)).float()
    if causal:
        s = q.shape[1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)
