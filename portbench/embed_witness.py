"""Witness of the embedding-gradient gap (PERF.md, Open questions, first).

    python3 -m portbench.embed_witness [--seed N] [--device cuda]

For the flagship at B1 x S16384 and at B8 x S1024, with Zipf ids and
with uniform ids, one forward and backward of the port's model on the
benchmark's weights and first batch, and the norm of the embedding's
gradient three ways:

- ``program_bf16``: the port's bf16 model as the timed path runs it
  (the bf16 cast of the table indexed by the tokens, so the positions'
  gradients are added into a bf16 [V, D] buffer);
- ``upstream_fp32_sum``: the same upstream gradient (captured at the
  embedding's output) added per token in fp32;
- ``program_fp32`` (the port's float32 path) and ``reference`` (the
  plain reference).

Prints one JSON line per traffic, with the commonest id's count and its
row's ratio of bf16 to fp32 sums.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from portbench import spec, traffic, weights
from portbench.models import transformer_lm as family
from portbench.reference import precision
from portbench.reference import transformer_lm as reference

S16K = {"batch": 1, "seq": 16384, "pool": 4}
TRAFFICS = (dict(S16K, token_law="zipf"), {"token_law": "zipf"},
            dict(S16K, token_law="uniform"), {"token_law": "uniform"})


def witness(cfg, tr, seed, device) -> dict:
    from tpu_dra_torch.workloads import model as port

    leaves = reference.leaves(cfg)
    tokens = traffic.batches(tr, cfg["vocab"], seed, device)[0]
    idx = tokens[:, :-1].reshape(-1)
    out = {}
    for dtype, tag in ((torch.bfloat16, "program_bf16"),
                       (torch.float32, "program_fp32")):
        _, tree = weights.make(leaves, seed, device)
        mcfg = dataclasses.replace(family.model_config(cfg, tr["seq"]),
                                   dtype=dtype)
        model = port.TransformerLM(mcfg, tree)
        upstream = []
        embed_tokens = model.embed_tokens

        def hooked(t):
            x = embed_tokens(t)
            x.register_hook(upstream.append)
            return x

        model.embed_tokens = hooked
        (grad,) = torch.autograd.grad(port.loss_fn(model, tokens),
                                      [model.embed])
        out[tag] = float(grad.norm())
        if dtype == torch.bfloat16:
            summed = torch.zeros_like(grad).index_add_(
                0, idx, upstream[0].reshape(-1, cfg["d_model"]).float())
            out["upstream_fp32_sum"] = float(summed.norm())
            counts = torch.bincount(idx, minlength=cfg["vocab"])
            top = int(counts.argmax())
            out["top_id_count"] = int(counts[top])
            out["top_row_ratio"] = float(grad[top].norm() / summed[top].norm())
        del model, grad, tree, upstream
    with precision.fp32_matmuls():
        flat, _ = weights.make(leaves, seed, device)
        flat.requires_grad_(True)
        (grad,) = torch.autograd.grad(
            reference.loss(cfg, weights.tree_of(flat, leaves), tokens), flat)
        out["reference"] = float(grad[weights.slices(leaves)[0]].norm())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.embed_witness")
    p.add_argument("--seed", type=int, default=3_000_000_019)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.resolve("flagship.s1k_uniform")
    for over in TRAFFICS:
        tr = dict(cell.traffic, **over)
        row = witness(cell.config, tr, args.seed, torch.device(args.device))
        print(json.dumps({"seed": args.seed, "traffic": over, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
