"""The port's MoE LM as the timed path drives it, and what the benchmark
counts of its work.

``build`` is tpu_dra_torch/bench.py:_setup's MoE branch (a
``MoETransformerLM`` on a parameter tree, then its train step), on the
benchmark's own weight views.

``flops_per_token`` is the benchmark's own count of the model's active
FLOPs: each token passes the router and ONE expert's W_up and W_down
(top-1), besides attention and the dense blocks. The port's dense
one-hot dispatch and combine (``moe.py:_experts``) compute far more; that
is implementation, not model work, and a change that replaces them leaves
this count as it is.
"""

from __future__ import annotations

from typing import Any, Dict

from portbench import frozen
from portbench.models import transformer_lm as dense
from portbench.models.transformer_lm import FAULTS, attention_calls  # noqa: F401


def model_config(cfg: Dict[str, Any], seq: int):
    from tpu_dra_torch.workloads.moe_model import MoEModelConfig

    return MoEModelConfig(vocab=cfg["vocab"], d_model=cfg["d_model"],
                          n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                          d_ff=cfg["d_ff"], max_seq=seq,
                          n_experts=cfg["n_experts"],
                          moe_every=cfg["moe_every"],
                          capacity_factor=cfg["capacity_factor"],
                          router_aux_weight=cfg["router_aux_weight"])


def _moe_terms(model, tokens):
    from tpu_dra_torch.workloads.model import token_nll

    logits, aux = model(tokens[:, :-1])
    return (token_nll(model, logits, tokens[:, 1:]),
            model.cfg.router_aux_weight * aux)


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, *,
          fault: str = None):
    """The port's MoE train step on `tree`: step(tokens) -> loss."""
    from tpu_dra_torch.workloads import model as port
    from tpu_dra_torch.workloads import moe_model

    model = moe_model.MoETransformerLM(model_config(cfg, traffic["seq"]),
                                       tree)
    if fault is None:
        return moe_model.make_train_step(model, lr=cfg["lr"])
    if fault == "unchanged":
        return port.build_train_step(model, 0.0, moe_model.loss_fn)
    if fault == "half_batch":
        return port.build_train_step(model, cfg["lr"],
                                     dense.half_batch(_moe_terms))
    raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")


def active_params(cfg: Dict[str, Any]) -> int:
    """Parameters one token passes through: the dense model's (one FFN a
    block) plus each MoE block's router."""
    moe_blocks = sum(1 for i in range(cfg["n_layers"])
                     if i % cfg["moe_every"] == cfg["moe_every"] - 1)
    return (dense.n_params(cfg)
            + moe_blocks * cfg["d_model"] * cfg["n_experts"])


def flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    """Active model FLOPs per trained token: frozen.flops_per_token over
    the active parameters."""
    flops, _ = frozen.flops_per_token(cfg["vocab"], cfg["d_model"],
                                      cfg["n_layers"], seq, active_params(cfg))
    return flops


def total_params(cfg: Dict[str, Any]) -> int:
    from portbench.reference import moe_lm as reference

    return sum(dense._numel(shape) for _, shape, _ in reference.leaves(cfg))

