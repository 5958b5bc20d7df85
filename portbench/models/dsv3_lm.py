"""The port's DeepSeek-V3-family LM as the timed path drives it, and what
the benchmark counts of its work.

``build`` constructs ``dsv3_model.DSV3LM`` on the benchmark's own weight
views and its train step (``model.build_train_step`` with the family's
loss), the configuration's keys mapped onto ``DSV3Config``.

``flops_per_token`` is the benchmark's own count of the model's work per
trained token: 6 x the matmul parameters a token passes (every
projection but the input embedding's gather: attention, the dense FFN,
the router, the shared expert, the unembedding, and of the routed
experts the share a token reaches on this chip, num_experts_per_tok x
held / router experts = 6 x 8 / 64 = 0.75 of one expert a layer) plus
causal attention's matmuls, 3 x L x S x H x (Dqk + Dv) (QK^T and PV,
forward and backward, over S/2 keys on average).

``mla_attention_bounds`` and ``moe_kernel_bytes`` are the work the new
kernels' roofline shares (metrics/kernels.mla_attn_roofline.py,
kernels.moe_route_roofline.py) are measured against.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench.models import transformer_lm as dense
from portbench.models.transformer_lm import FAULTS  # noqa: F401
from portbench.reference import dsv3_lm as reference


def model_config(cfg: Dict[str, Any], seq: int):
    from tpu_dra_torch.workloads.dsv3_model import DSV3Config

    lo = cfg["experts_held"][0]
    return DSV3Config(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        max_seq=seq, norm_eps=cfg["rms_norm_eps"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        kv_rank=cfg["kv_lora_rank"], rope_theta=float(cfg["rope_theta"]),
        first_dense=cfg["first_k_dense_replace"],
        moe_d_ff=cfg["moe_intermediate_size"],
        n_routed=cfg["router_experts"],
        experts_held=(lo, lo + cfg["n_routed_experts"]),
        top_k=cfg["num_experts_per_tok"], n_shared=cfg["n_shared_experts"],
        routed_scale=cfg["routed_scaling_factor"],
        aux_weight=cfg["aux_loss_alpha"])


def _terms(model, tokens):
    from tpu_dra_torch.workloads.model import token_nll

    logits, aux = model(tokens[:, :-1])
    return (token_nll(model, logits, tokens[:, 1:]),
            model.cfg.aux_weight * aux)


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, *,
          fault: str = None):
    """The port's train step on `tree`: step(tokens) -> loss. `fault`
    plants one of FAULTS (tests and calibration only)."""
    from tpu_dra_torch.workloads import dsv3_model
    from tpu_dra_torch.workloads import model as port

    model = dsv3_model.DSV3LM(model_config(cfg, traffic["seq"]), tree)
    if fault is None:
        return dsv3_model.make_train_step(model, lr=cfg["lr"])
    if fault == "unchanged":
        return port.build_train_step(model, 0.0, dsv3_model.loss_fn)
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


def flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    """Model FLOPs per trained token at sequence length `seq`."""
    attn = (3 * cfg["num_hidden_layers"] * seq * cfg["num_attention_heads"]
            * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
               + cfg["v_head_dim"]))
    return 6 * active_matmul_params(cfg) + attn


def attention_calls(cfg: Dict[str, Any], batch: int,
                    seq: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, S, H, Dqk, Dv) of each attention call of one step: one per
    layer, over the S - 1 input positions, each run forward and
    backward."""
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return [(batch, seq - 1, cfg["num_attention_heads"], dqk,
             cfg["v_head_dim"])] * cfg["num_hidden_layers"]


def mla_attention_bounds(b, s, h, dqk, dv, peak_flops, peak_bytes,
                         elem=2) -> dict:
    """Least time for one causal attention call whose q and k have head
    dim `dqk` and v `dv`, without rope tables: the larger of its
    tensor-core FLOPs over `peak_flops` and its compulsory bytes over
    `peak_bytes`, forward and fused backward.

    Pairs are the causal ones, B H S (S + 1) / 2. Forward: QK^T and PV,
    2 (Dqk + Dv) FLOPs a pair; q, k, v in, o and lse out. Backward: QK^T,
    dO V^T, P^T dO, dS^T Q and dS K, 2 (3 Dqk + 2 Dv) FLOPs a pair; q, k,
    v, dO, lse, delta and dlse in, dq, dk and dv out. At Dqk = Dv = D
    the FLOPs are frozen.bounds' (4 D and 10 D a pair)."""
    pairs = b * h * s * (s + 1) // 2
    qk = b * s * h * dqk * elem       # one q- or k-shaped operand
    vo = b * s * h * dv * elem        # one v-shaped operand
    row = b * h * s * 4               # one fp32 [B, H, S] row vector
    work = {
        "flash_fwd": (2 * (dqk + dv) * pairs, 2 * qk + 2 * vo + row),
        "flash_bwd": (2 * (3 * dqk + 2 * dv) * pairs,
                      4 * qk + 3 * vo + 3 * row),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out


# The MoE layer's own CUDA kernels (csrc/moe_route.cu), by a fragment of
# the name the trace gives each.
MOE_KERNELS = ("route_topk_kernel", "gather_rows_kernel",
               "combine_rows_kernel", "row_dot_kernel")


def moe_kernel_bytes(t: int, pairs: float, n: float, u: float,
                     row: float) -> float:
    """Compulsory bytes of one MoE block's own kernels in one step,
    forward and backward, for t tokens routed, `pairs` (token, k) pairs
    selected (t k), n of them held (moe.assigned), u tokens with a held
    pair (moe.tokens_held), rows of `row` bytes; each input byte read
    once and each output written once:

    - route: the t k expert ids in; each pair's row, each row's pair and
      token out (int32);
    - dispatch, a gather: u token rows and n row indices in, n rows out;
    - combine, a k-way sum: n rows, t k gates and row indices in, t rows
      out;
    - the dispatch's backward, a k-way sum: n rows and t k indices in, t
      rows out;
    - the combine's backward, a gather: u rows of dout, n indices and
      gates in, n rows out; and a pair dot: u rows of dout (a pair not
      held reads none), n rows, t k indices in, t k fp32 gate gradients
      out.
    """
    route = 4 * pairs + 4 * (pairs + 2 * n)
    dispatch = u * row + 4 * n + n * row
    combine = n * row + 8 * pairs + t * row
    dispatch_bwd = n * row + 4 * pairs + t * row
    combine_bwd = (u * row + 8 * n + n * row
                   + u * row + n * row + 4 * pairs + 4 * pairs)
    return float(route + dispatch + combine + dispatch_bwd + combine_bwd)
