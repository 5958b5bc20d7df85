"""The port's dense TransformerLM as the timed path drives it, and what the
benchmark counts of its work.

``build`` is tpu_dra_torch/bench.py:_setup's construction (a
``TransformerLM`` on a parameter tree, then its train step), on the
benchmark's own weight views rather than the port's ``init_params``, so
that the reference can make the same weights again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench import frozen
from portbench.reference import transformer_lm as reference

FAULTS = ("unchanged", "half_batch")


def model_config(cfg: Dict[str, Any], seq: int):
    from tpu_dra_torch.workloads.model import ModelConfig

    return ModelConfig(vocab=cfg["vocab"], d_model=cfg["d_model"],
                       n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                       d_ff=cfg["d_ff"], max_seq=seq)


def half_batch(loss_of_tokens):
    """A planted fault: the mean taken over the first half of the batch's
    trained tokens, the rest left out."""
    def loss(model, tokens):
        per_token, extra = loss_of_tokens(model, tokens)
        flat = per_token.reshape(-1)
        return flat[:flat.numel() // 2].mean() + extra
    return loss


def _dense_terms(model, tokens):
    from tpu_dra_torch.workloads.model import token_nll

    logits = model(tokens[:, :-1])
    return token_nll(model, logits, tokens[:, 1:]), 0.0


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], tree, *,
          fault: str = None):
    """The port's train step on the parameter tree `tree`: step(tokens)
    -> loss. `fault` plants one of FAULTS (tests and calibration only)."""
    from tpu_dra_torch.workloads import model as port

    model = port.TransformerLM(model_config(cfg, traffic["seq"]), tree)
    if fault is None:
        return port.make_train_step(model, lr=cfg["lr"])
    if fault == "unchanged":
        return port.build_train_step(model, 0.0, port.loss_fn)
    if fault == "half_batch":
        return port.build_train_step(model, cfg["lr"],
                                     half_batch(_dense_terms))
    raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")


def n_params(cfg: Dict[str, Any]) -> int:
    return sum(_numel(shape) for _, shape, _ in reference.leaves(cfg))


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def flops_per_token(cfg: Dict[str, Any], seq: int) -> float:
    """Model FLOPs per trained token (frozen.flops_per_token at the
    traffic's sequence length)."""
    flops, _ = frozen.flops_per_token(cfg["vocab"], cfg["d_model"],
                                      cfg["n_layers"], seq, n_params(cfg))
    return flops


def attention_calls(cfg: Dict[str, Any], batch: int,
                    seq: int) -> List[Tuple[int, int, int, int]]:
    """(B, S, H, d) of each attention call of one step: one per layer,
    over the S - 1 input positions, each run forward and backward."""
    heads = cfg["n_heads"]
    return [(batch, seq - 1, heads, cfg["d_model"] // heads)] * cfg["n_layers"]
