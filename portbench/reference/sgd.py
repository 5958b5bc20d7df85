"""The reference's first train steps and the readings the check compares.

The reference makes the run's weights again from its seed (the same
draw the program was built on), trains on the same first batches with
plain SGD, and reads what the program's readings are compared with:
each step's loss, the per-leaf norm of the first gradient (worked out
from the state after one step, as the program's is) and the per-leaf
norm of the change after all the steps.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from portbench import weights
from portbench.reference import precision as prec


def readings(family, cfg: Dict[str, Any], seed: int, batches: Sequence,
             lr: float, device, precision: str = "fp32") -> Dict[str, Any]:
    """{"losses", "grad1", "change"} of len(batches) SGD steps of the
    reference module `family` (``transformer_lm`` or ``moe_lm``) in
    `precision`."""
    leaves = family.leaves(cfg)
    with prec.fp32_matmuls():
        flat, _ = weights.make(leaves, seed, device)
        start = flat.clone()
        flat.requires_grad_(True)
        losses, grad1 = [], None
        for i, tokens in enumerate(batches):
            value = family.loss(cfg, weights.tree_of(flat, leaves), tokens,
                                precision)
            (grad,) = torch.autograd.grad(value, flat)
            with torch.no_grad():
                flat.sub_(grad, alpha=lr)
            del grad
            losses.append(float(value.detach()))
            if i == 0:
                grad1 = weights.leaf_norms(start, flat.detach(), leaves,
                                           1.0 / lr)
        change = weights.leaf_norms(flat.detach(), start, leaves)
    return {"losses": losses, "grad1": grad1, "change": change}

