"""Multi-head latent attention (MLA), the attention of the DeepSeek-V2/V3
family (arXiv:2405.04434 §2.1; the V3 paper, arXiv:2412.19437 §2.1), as
its models without a query down-projection (q_lora_rank null) run it.

On the normed residual h:

- q = h W_q, per head [q_nope | q_pe] (nope and rope dims);
- [c | k_pe] = h W_kva: c the latent (kv_rank wide), k_pe one roped key
  part shared by every head; c = RMSNorm(c);
- [k_nope | v] = c W_kvb, per head;
- q_pe and k_pe rotated by their 0-based positions, plane j at
  theta_j = rope_theta^(-2j / rope_dims), with half-split pairing: plane j
  rotates dims (j, j + rope_dims / 2). DeepSeek's code pairs interleaved
  dims (2j, 2j + 1); half-split pairing permutes q_pe and k_pe alike and
  leaves every score as it was;
- k = [k_nope | k_pe], o = softmax_causal(q k^T / sqrt(nope + rope)) v,
  then o W_o.

Attention is ``flashattention.attend`` with rope=False: on the card the
Hopper kernels at (q.k, v) head dims (192, 128), the rotation applied
here to the roped dims only. Projections run in the config's dtype over
fp32 masters, as the flagship's do.
"""

from __future__ import annotations

import functools

import torch

from tpu_dra_torch.infra.trace import device_span
from tpu_dra_torch.workloads.flashattention import attend
from tpu_dra_torch.workloads.model import _rmsnorm


@functools.lru_cache(maxsize=16)
def rope_tables(s: int, dims: int, theta: float, device: torch.device):
    """fp32 (cos, sin) [S, dims / 2] of positions 0..S-1 at
    theta_j = theta^(-2j / dims)."""
    j = torch.arange(dims // 2, dtype=torch.float64)
    freqs = theta ** (-2.0 * j / dims)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * freqs
    return (ang.cos().float().to(device), ang.sin().float().to(device))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, R] rotated plane by plane (dims j, j + R/2) in fp32,
    x.dtype out."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def mla(cfg, p, h: torch.Tensor) -> torch.Tensor:
    """o W_o [B, S, D] of the normed h [B, S, D]; `p` holds wq [D,
    H (nope + rope)], wkv_a [D, kv_rank + rope], kv_norm [kv_rank], wkv_b
    [kv_rank, H (nope + v)] and wo [H v, D] (fp32 masters, [in, out]).

    Under torch.profiler the projections, the latent's norm, the rotation
    and the assembly of q and k are the range ``mla.project``."""
    cd = cfg.dtype
    b, s, _ = h.shape
    heads, nope, rdims = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    with device_span("mla.project"):
        q = (h @ p["wq"].to(cd)).view(b, s, heads, nope + rdims)
        c, k_pe = (h @ p["wkv_a"].to(cd)).split([cfg.kv_rank, rdims], -1)
        c = _rmsnorm(c, p["kv_norm"], cfg.norm_eps)
        kv = (c @ p["wkv_b"].to(cd)).view(b, s, heads, nope + cfg.v_head_dim)
        k_nope, v = kv.split([nope, cfg.v_head_dim], -1)
        cos, sin = rope_tables(s, rdims, cfg.rope_theta, h.device)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], -1)
        k_pe = rope(k_pe.view(b, s, 1, rdims), cos, sin)
        k = torch.cat([k_nope, k_pe.expand(b, s, heads, rdims)], -1)
    o = attend(q, k, v, causal=True, impl=cfg.attn_impl, rope=False)
    return o.reshape(b, s, heads * cfg.v_head_dim) @ p["wo"].to(cd)
