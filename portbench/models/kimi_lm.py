"""The port's Kimi Linear-family LM as the timed path drives it, and what
the benchmark counts of its work.

``build`` constructs ``kimi_model.KimiLM`` on the benchmark's own weight
views and its train step (``model.build_train_step`` with the family's
loss), the configuration's keys mapped onto ``KimiConfig``.

``flops_per_token`` is the benchmark's own count of the model's work per
trained token: 6 x the matmul parameters a token passes (every
projection but the input embedding's gather: KDA's and MLA's, the dense
FFN, the router, the shared expert, the unembedding, and of the routed
experts the share a token reaches on this chip, num_experts_per_token x
held / router experts = 8 x 8 / 256 = 0.25 of one expert a layer), plus
the MLA layers' causal attention matmuls, 3 x S x H x (Dqk + Dv) a layer
(QK^T and PV, forward and backward, over S/2 keys on average), plus the
KDA layers' chunk-form products (``kda_flops_per_token``, forward and a
backward of twice the forward).

``attention_calls`` lists the MLA calls (B, S, H, Dqk, Dv), which
metrics/kernels.mla_attn_roofline.py reads, and carries the KDA calls
(B, S, H, dk, dv) as its ``kda``; ``kda_bounds`` is the work the KDA
kernels' roofline share (metrics/kernels.kda_roofline.py) is measured
against. ``FAULTS`` adds two faults of the token mixer to the train
step's own: each head's decay made one scalar (Gated DeltaNet's gate),
and the delta rule's erase term dropped (gated linear attention).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

from portbench.models import dsv3_lm
from portbench.models import transformer_lm as dense
from portbench.reference import kimi_lm as reference

FAULTS = ("unchanged", "half_batch", "gate_per_head", "no_delta")
CHUNK = 64          # the chunk form's rows, as the work is counted
# no_delta scales k by this and v by its inverse: the erase term
# beta k k^T S shrinks by its square, the write term beta k v^T stays.
NO_DELTA_SCALE = 1e-3


def model_config(cfg: Dict[str, Any], seq: int):
    import torch

    from tpu_dra_torch.workloads._mixer_kernels import TAPS
    from tpu_dra_torch.workloads.kimi_model import KimiConfig

    heads, dk, taps = reference.kda_dims(cfg)
    layers = cfg["num_hidden_layers"]
    lo = cfg["experts_held"][0]
    if not cfg["mla_use_nope"] or cfg["q_lora_rank"] is not None:
        raise ValueError("the port's Kimi MLA layers are NoPE, with no q "
                         "down-projection")
    if taps != TAPS:
        raise ValueError(f"the port's short convs take {TAPS} taps, "
                         f"not {taps}")
    return KimiConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_layers=layers,
        d_ff=cfg["intermediate_size"], max_seq=seq,
        dtype=getattr(torch, cfg.get("compute_dtype", "bfloat16")),
        norm_eps=cfg["rms_norm_eps"], qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        kv_rank=cfg["kv_lora_rank"], rope_theta=float(cfg["rope_theta"]),
        mla_use_nope=True, first_dense=cfg["first_k_dense_replace"],
        moe_d_ff=cfg["moe_intermediate_size"],
        n_routed=cfg["router_experts"],
        experts_held=(lo, lo + cfg["num_experts"]),
        top_k=cfg["num_experts_per_token"],
        n_shared=cfg["num_shared_experts"],
        routed_scale=cfg["routed_scaling_factor"],
        aux_weight=cfg["aux_loss_alpha"],
        kda_pattern=tuple(int(reference.is_kda_block(cfg, i))
                          for i in range(layers)),
        kda_heads=heads, kda_head_dim=dk, kda_rank=dk,
        l2_eps=cfg["kda_l2_eps"], a_log_offset=cfg["a_log_offset"])


def _terms(model, tokens):
    from tpu_dra_torch.workloads.model import token_nll

    logits, aux = model(tokens[:, :-1])
    return (token_nll(model, logits, tokens[:, 1:]),
            model.cfg.aux_weight * aux)


class _FaultyChunk:
    """Stands in for kda._KDAChunk while a faulty step runs: the chunk
    kernels on inputs changed by `fault`."""

    def __init__(self, chunk, fault: str):
        self.chunk, self.fault = chunk, fault

    def apply(self, q, k, v, g, beta):
        if self.fault == "gate_per_head":
            g = g.mean(-1, keepdim=True).expand_as(g).contiguous()
        else:   # no_delta
            k = k * NO_DELTA_SCALE
            v = v * (1.0 / NO_DELTA_SCALE)
        return self.chunk.apply(q, k, v, g, beta)


def _with_fault(step, fault: str):
    from tpu_dra_torch.workloads import kda

    @contextlib.contextmanager
    def planted():
        chunk = kda._KDAChunk
        kda._KDAChunk = _FaultyChunk(chunk, fault)
        try:
            yield
        finally:
            kda._KDAChunk = chunk

    def faulty(tokens):
        with planted():
            return step(tokens)
    return faulty


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, *,
          fault: str = None):
    """The port's train step on `tree`: step(tokens) -> loss. `fault`
    plants one of FAULTS (tests and calibration only): ``gate_per_head``
    runs every KDA layer with each head's decay replaced by its mean over
    the channels, ``no_delta`` with k scaled by NO_DELTA_SCALE and v by
    its inverse (the erase term gone, the rest as it was)."""
    from tpu_dra_torch.workloads import kimi_model
    from tpu_dra_torch.workloads import model as port

    model = kimi_model.KimiLM(model_config(cfg, traffic["seq"]), tree)
    if fault is None:
        return kimi_model.make_train_step(model, lr=cfg["lr"])
    if fault in ("gate_per_head", "no_delta"):
        return _with_fault(kimi_model.make_train_step(model, lr=cfg["lr"]),
                           fault)
    if fault == "unchanged":
        return port.build_train_step(model, 0.0, kimi_model.loss_fn)
    if fault == "half_batch":
        return port.build_train_step(model, cfg["lr"],
                                     dense.half_batch(_terms))
    raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")


def total_params(cfg: Dict[str, Any]) -> int:
    return sum(dense._numel(shape) for _, shape, _ in reference.leaves(cfg))


def active_matmul_params(cfg: Dict[str, Any]) -> float:
    """Matmul parameters one token passes on this chip: every leaf of two
    dims or more but the embedding, the routed experts and the convs
    (depthwise: 4 taps a channel, no product), plus the routed experts'
    share a token reaches, num_experts_per_token / router_experts of the
    held ones."""
    reach = cfg["num_experts_per_token"] / cfg["router_experts"]
    total = 0.0
    for path, shape, _ in reference.leaves(cfg):
        if (len(shape) < 2 or path == ("embed",)
                or path[-1] in ("q_conv", "k_conv", "v_conv")):
            continue
        n = dense._numel(shape)
        routed = path[-2:-1] == ("moe",) and path[-1] in ("w_gate", "w_up",
                                                          "w_down")
        total += n * reach if routed else n
    return total


def kda_flops_per_token(dk: int, dv: int, chunk: int = CHUNK) -> float:
    """Forward FLOPs of one head of the chunk form per token, at chunks
    of `chunk` rows: the pair products A~ and P (C^2 / 2 pairs of dk each
    a chunk, 2 FLOPs a term), the substitution for W and U~ (C^2 / 2
    pairs over dk + dv columns), U = U~ - W S, (q exp G) S and Kh^T U
    (C dk dv each), P U (C^2 / 2 pairs over dv)."""
    c = chunk
    per_chunk = (2 * (c * c / 2) * dk * 2 + (c * c / 2) * (dk + dv) * 2
                 + 3 * c * dk * dv * 2 + (c * c / 2) * dv * 2)
    return per_chunk / c


def flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    """Model FLOPs per trained token at sequence length `seq`."""
    mla_layers = sum(not reference.is_kda_block(cfg, i)
                     for i in range(cfg["num_hidden_layers"]))
    attn = (3 * mla_layers * seq * cfg["num_attention_heads"]
            * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
               + cfg["v_head_dim"]))
    heads, dk, _ = reference.kda_dims(cfg)
    kda_layers = cfg["num_hidden_layers"] - mla_layers
    kda = 3 * kda_layers * heads * kda_flops_per_token(dk, dk)
    return 6 * active_matmul_params(cfg) + attn + kda


class Calls(list):
    """The MLA calls (B, S, H, Dqk, Dv) of one step, carrying the KDA
    calls (B, S, H, dk, dv) as ``kda``."""

    def __init__(self, mla, kda):
        super().__init__(mla)
        self.kda = list(kda)


def attention_calls(cfg: Dict[str, Any], batch: int, seq: int) -> Calls:
    """Each token mixer's call of one step, over the S - 1 input
    positions, each run forward and backward."""
    heads, dk, _ = reference.kda_dims(cfg)
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    mla, kda = [], []
    for i in range(cfg["num_hidden_layers"]):
        if reference.is_kda_block(cfg, i):
            kda.append((batch, seq - 1, heads, dk, dk))
        else:
            mla.append((batch, seq - 1, cfg["num_attention_heads"], dqk,
                        cfg["v_head_dim"]))
    return Calls(mla, kda)


def kda_bounds(b, s, h, dk, dv, peak_flops, peak_bytes) -> dict:
    """Least time for one KDA call (B, S, H, dk, dv): the larger of its
    chunk-form FLOPs (kda_flops_per_token at C = 64; the backward twice
    the forward) over `peak_flops` and its compulsory bytes over
    `peak_bytes`, forward and backward, whatever the kernels keep or
    recompute. Forward: q, k, v in and o out at 2 bytes an element, g
    (dk per token) and beta (one per token) in at 4. Backward: q, k, v,
    g, beta and dO in; dq, dk, dv, dg and dbeta out, at the same widths."""
    n = b * s * h                     # (token, head) rows
    q = n * dk * 2                    # q or k (and dq or dk)
    v = n * dv * 2                    # v or o (and dv or dO)
    g = n * dk * 4                    # g (and dg)
    beta = n * 4                      # beta (and dbeta)
    fwd_flops = n * kda_flops_per_token(dk, dv)
    work = {
        "kda_fwd": (fwd_flops, 2 * q + 2 * v + g + beta),
        "kda_bwd": (2 * fwd_flops, 2 * (2 * q + v + g + beta) + v),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


# The MoE layer's kernels and their bytes are the DeepSeek-V3 family's.
MOE_KERNELS = dsv3_lm.MOE_KERNELS
moe_kernel_bytes = dsv3_lm.moe_kernel_bytes
# A fragment of the name of every KDA kernel (csrc/kda_chunk.cu).
KDA_KERNEL = "kda_"
