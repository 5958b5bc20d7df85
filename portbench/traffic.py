"""The general generator of training traffic: a pool of token batches.

A traffic file (traffic/<name>.json) gives the batch, the sequence
length, the law token ids are drawn by and how many distinct batches the
pool holds. Every seed gets the same sizes; the seed only picks the ids.
The pool is drawn on the device in one call; step i of a run trains on
batch i of the pool, cycling.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from portbench.weights import sub_seed

LAWS = ("zipf", "uniform")


def token_probs(vocab: int, law: str, zipf_s: float = 1.0,
                device="cpu") -> torch.Tensor:
    """Probability of each id: Zipf's law p(k) ~ 1 / (k + 1)^s, the unigram
    statistics of natural text (id 0 the commonest), or uniform."""
    if law == "zipf":
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        weights = ranks.pow(-float(zipf_s))
    elif law == "uniform":
        weights = torch.ones(vocab, dtype=torch.float64, device=device)
    else:
        raise ValueError(f"unknown token law {law!r} (have {LAWS})")
    return (weights / weights.sum()).float()


def batches(traffic: Dict[str, Any], vocab: int, seed: int,
            device) -> torch.Tensor:
    """[pool, batch, seq] int64 token ids for `seed`, drawn on `device`."""
    pool, batch, seq = (int(traffic[k]) for k in ("pool", "batch", "seq"))
    probs = token_probs(vocab, traffic["token_law"],
                        traffic.get("zipf_s", 1.0), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 2))
    ids = torch.multinomial(probs, pool * batch * seq, replacement=True,
                            generator=gen)
    return ids.view(pool, batch, seq)
