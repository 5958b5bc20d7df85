"""The port's MiMo-V2-Flash-family LM as the timed path drives it, and
what the benchmark counts of its work.

``build`` constructs ``mimo_model.MiMoLM`` on the benchmark's own weight
views and its train step (``model.build_train_step`` with the family's
loss), the configuration's keys mapped onto ``MiMoConfig``.

``flops_per_token`` is the benchmark's own count of the model's work per
trained token: 6 x the matmul parameters a token passes (every
projection but the input embedding's gather: attention, the dense FFN,
the router, the unembedding, and of the routed experts the share a token
reaches on this chip, num_experts_per_tok x held / router experts = 8 x
8 / 256 = 0.25 of one expert a layer) plus attention's matmuls, QK^T and
PV forward and backward, 6 x H x (Dqk + Dv) a key a row: a global layer
over (n + 1) / 2 keys a row on average, a window layer over
band_pairs(n, W) / n (min(i + 1, W) keys at row i), n the S - 1 trained
positions.

``hybrid_attention_bounds`` is the work the new kernels' roofline shares
(metrics/kernels.gqa_attn_roofline.py, kernels.swa_attn_roofline.py) are
measured against; ``FAULTS`` adds two faults of the hybrid attention to
the train step's own: the sinks dropped, and a window of 256 keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from portbench.models import dsv3_lm
from portbench.models import transformer_lm as dense
from portbench.reference import mimo_lm as reference

FAULTS = ("unchanged", "half_batch", "sink_dropped", "window_256")


def model_config(cfg: Dict[str, Any], seq: int):
    from tpu_dra_torch.workloads.mimo_model import MiMoConfig

    for swa, full in (("swa_head_dim", "head_dim"),
                      ("swa_v_head_dim", "v_head_dim"),
                      ("swa_num_attention_heads", "num_attention_heads")):
        if cfg[swa] != cfg[full]:
            raise ValueError(f"{swa} {cfg[swa]} != {full} {cfg[full]}: the "
                             "port's window layers share the global ones' "
                             "heads and head dims")
    layers = cfg["num_hidden_layers"]
    freq = cfg["moe_layer_freq"][:layers]
    first_dense = freq.index(1) if 1 in freq else layers
    if any(not f for f in freq[first_dense:]):
        raise ValueError(f"moe_layer_freq {freq}: dense layers only lead")
    lo = cfg["experts_held"][0]
    return MiMoConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_layers=layers,
        d_ff=cfg["intermediate_size"], max_seq=seq,
        norm_eps=cfg["layernorm_epsilon"],
        n_kv_heads=cfg["num_key_value_heads"],
        swa_kv_heads=cfg["swa_num_key_value_heads"],
        qk_head_dim=cfg["head_dim"], v_head_dim=cfg["v_head_dim"],
        rope_dims=reference.rope_dims(cfg),
        rope_theta=float(cfg["rope_theta"]),
        swa_rope_theta=float(cfg["swa_rope_theta"]),
        window=cfg["sliding_window"],
        hybrid_pattern=tuple(cfg["hybrid_layer_pattern"][:layers]),
        sink_offset=float(cfg["sink_offset"]),
        value_scale=float(cfg["attention_value_scale"]),
        first_dense=first_dense, moe_d_ff=cfg["moe_intermediate_size"],
        n_routed=cfg["router_experts"],
        experts_held=(lo, lo + cfg["n_routed_experts"]),
        top_k=cfg["num_experts_per_tok"], aux_weight=cfg["aux_loss_alpha"])


def _terms(model, tokens):
    from tpu_dra_torch.workloads.model import token_nll

    logits, aux = model(tokens[:, :-1])
    return (token_nll(model, logits, tokens[:, 1:]),
            model.cfg.aux_weight * aux)


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, *,
          fault: str = None):
    """The port's train step on `tree`: step(tokens) -> loss. `fault`
    plants one of FAULTS (tests and calibration only): ``sink_dropped``
    runs every window layer without its sink (a logit of -1e4: no mass,
    no gradient), ``window_256`` with a window of 256 keys."""
    import torch

    from tpu_dra_torch.workloads import mimo_model
    from tpu_dra_torch.workloads import model as port

    mcfg = model_config(cfg, traffic["seq"])
    if fault == "sink_dropped":
        mcfg = dataclasses.replace(mcfg, sink_offset=-1e4)
    elif fault == "window_256":
        mcfg = dataclasses.replace(mcfg, window=256)
    model = mimo_model.MiMoLM(mcfg, tree)
    # This cell's process runs the caching allocator with expandable
    # segments: the top-k layer's buffers change size with every batch
    # (the held rows vary by a fifth between batches), and at this
    # model's ~72 GB peak fixed segments keep growing through the first
    # steps of new batches (on an H100, ~77 device allocations in the
    # first step after the first three, up to 0.26 s of a ~1 s step);
    # expandable segments grow in place and make none there.
    if model.embed.device.type == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    if fault in (None, "sink_dropped", "window_256"):
        return mimo_model.make_train_step(model, lr=cfg["lr"])
    if fault == "unchanged":
        return port.build_train_step(model, 0.0, mimo_model.loss_fn)
    if fault == "half_batch":
        return port.build_train_step(model, cfg["lr"],
                                     dense.half_batch(_terms))
    raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")


def total_params(cfg: Dict[str, Any]) -> int:
    return sum(dense._numel(shape) for _, shape, _ in reference.leaves(cfg))


def active_matmul_params(cfg: Dict[str, Any]) -> float:
    """Matmul parameters one token passes on this chip: every leaf of two
    dims or more but the embedding and the routed experts, plus the
    routed experts' share a token reaches, num_experts_per_tok /
    router_experts of the held ones."""
    reach = cfg["num_experts_per_tok"] / cfg["router_experts"]
    total = 0.0
    for path, shape, _ in reference.leaves(cfg):
        if len(shape) < 2 or path == ("embed",):
            continue
        n = dense._numel(shape)
        routed = path[-2:-1] == ("moe",) and path[-1] in ("w_gate", "w_up",
                                                          "w_down")
        total += n * reach if routed else n
    return total


def band_pairs(n: int, window: int) -> int:
    """(query, key) pairs of one head of a causal call over n positions:
    sum over i of min(i + 1, W), or of i + 1 with no window (W 0)."""
    w = min(window, n) if window else n
    return w * (w + 1) // 2 + (n - w) * w


def flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    """Model FLOPs per trained token at sequence length `seq`."""
    n = seq - 1
    per_key = 6 * cfg["num_attention_heads"] * (cfg["head_dim"]
                                                + cfg["v_head_dim"])
    attn = sum(per_key * band_pairs(n, call[-1]) / n
               for call in attention_calls(cfg, 1, seq))
    return 6 * active_matmul_params(cfg) + attn


def attention_calls(cfg: Dict[str, Any], batch: int,
                    seq: int) -> List[Tuple[int, int, int, int, int, int, int]]:
    """(B, S, Hq, Hkv, Dqk, Dv, W) of each attention call of one step,
    W 0 for a global layer: one per layer, over the S - 1 input
    positions, each run forward and backward."""
    return [(batch, seq - 1, cfg["num_attention_heads"],
             reference.kv_heads(cfg, i), cfg["head_dim"], cfg["v_head_dim"],
             cfg["sliding_window"] if reference.is_window_block(cfg, i)
             else 0)
            for i in range(cfg["num_hidden_layers"])]


def hybrid_attention_bounds(b, s, hq, hkv, dqk, dv, window, peak_flops,
                            peak_bytes, elem=2, pairs=None) -> dict:
    """Least time for one causal attention call, query heads hq over hkv
    K/V heads, q and k of head dim `dqk` and v `dv`, over every earlier
    key (window 0) or the last `window`, without rope tables: the larger
    of its tensor-core FLOPs over `peak_flops` and its compulsory bytes
    over `peak_bytes`, forward and fused backward.

    Pairs are B Hq band_pairs(S, W), or `pairs` where the caller counted
    them. Forward: QK^T and PV, 2 (Dqk + Dv) FLOPs a pair; q, k, v in, o
    and lse out. Backward: QK^T, dO V^T, P^T dO, dS^T Q and dS K,
    2 (3 Dqk + 2 Dv) FLOPs a pair; q, k, v, dO, lse, delta and dlse in,
    dq, dk and dv out. k, v, dk and dv hold Hkv heads. At Hkv = Hq and no
    window these are dsv3_lm.mla_attention_bounds'."""
    if pairs is None:
        pairs = b * hq * band_pairs(s, window)
    q = b * s * hq * dqk * elem       # q (and dq)
    k = b * s * hkv * dqk * elem      # k (and dk)
    v = b * s * hkv * dv * elem       # v (and dv)
    o = b * s * hq * dv * elem        # o (and dO)
    row = b * hq * s * 4              # one fp32 [B, H, S] row vector
    work = {
        "flash_fwd": (2 * (dqk + dv) * pairs, q + k + v + o + row),
        "flash_bwd": (2 * (3 * dqk + 2 * dv) * pairs,
                      2 * q + 2 * k + 2 * v + o + 3 * row),
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
