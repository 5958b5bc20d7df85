"""Launch the LM loss head's cross-entropy kernels (csrc/loss_head.cu).

Two wrappers, one per C entry point, each with its plain PyTorch version
beside it, over bf16 logits [N, V] and int64 targets [N]:

- ``lse_nll`` (``loss_lse_nll``): (lse, nll), fp32 [N]: lse =
  logsumexp(logits) and nll = lse - logits[target], per row.
- ``dlogits`` (``loss_dlogits``): dnll * (softmax(logits) - onehot(target))
  per row, from the forward's lse and the upstream gradient dnll (fp32
  [N]), taken in fp32 and rounded once to the logits' dtype.

The plain versions are the port's arithmetic before the kernels: the
logits cast to fp32, ``torch.logsumexp`` and a gather. The source's
header says what bounds the kernels on the H100 and what their design
does about it; they replace no TPU kernel (the reference computes the
loss in XLA). _cuda.py builds, loads and launches them; this module
declares the source's entry points there. For CPU tensors each wrapper
runs its plain version; for CUDA tensors it launches its kernel on the
current stream (_cuda.launch, which counts it under the entry's name),
or raises on logits it does not take. There is no other path.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads import _cuda

# The logits the kernels take: bf16, rows of a multiple of VOCAB_MULTIPLE
# (16-byte loads), contiguous from a 16-byte boundary.
KERNEL_DTYPE = torch.bfloat16
VOCAB_MULTIPLE = 8

_PTR, _INT = _cuda.PTR, _cuda.INT
# The C entry points of csrc/loss_head.cu; each takes the stream last.
ARGTYPES = {
    # logits, targets, lse, nll; rows, vocab.
    "loss_lse_nll": [_PTR] * 4 + [_INT] * 2 + [_PTR],
    # logits, targets, lse, dnll, dlogits; rows, vocab.
    "loss_dlogits": [_PTR] * 5 + [_INT] * 2 + [_PTR],
}
_cuda.declare({"loss_head": ARGTYPES})


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def lse_nll_plain(logits, targets):
    """lse_nll's function: logsumexp and a gather of the fp32 logits."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    return lse, lse - x.gather(-1, targets[..., None])[..., 0]


def bf16_ulps_apart(a, b):
    """Elementwise distance of two bf16 tensors in representable values
    (0 where equal, 1 one bf16 ulp apart; +0 and -0 equal): how the
    tests and chip_smoke.py hold dlogits against dlogits_plain."""
    def ordered(x):
        bits = x.view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def dlogits_plain(logits, targets, lse, dnll):
    """dlogits' function: dnll * (exp(x - lse) - onehot) in fp32, rounded
    once to the logits' dtype."""
    p = torch.exp(logits.float() - lse[..., None])
    p.scatter_add_(-1, targets[..., None],
                   torch.full_like(lse[..., None], -1.0))
    return (dnll[..., None] * p).to(logits.dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _rows(logits, targets):
    """(logits, targets) as the kernels take them, or raise."""
    if logits.dtype != KERNEL_DTYPE:
        raise TypeError(f"loss kernels take {KERNEL_DTYPE} logits, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.shape[1] % VOCAB_MULTIPLE:
        raise ValueError(f"logits must be [N, V] with V a multiple of "
                         f"{VOCAB_MULTIPLE}, got {tuple(logits.shape)}")
    logits = logits.contiguous()
    if logits.data_ptr() % 16:
        raise ValueError("logits must start on a 16-byte boundary")
    if targets.shape != logits.shape[:1]:
        raise ValueError(f"targets of shape {tuple(targets.shape)} for "
                         f"{logits.shape[0]} rows")
    return logits, targets.to(torch.int64).contiguous()


def _rows_vector(x, n):
    x = x.float().contiguous()
    if x.shape != (n,):
        raise ValueError(f"per-row vector of shape {tuple(x.shape)} for {n} "
                         f"rows")
    return x


def lse_nll(logits, targets):
    """(lse [N], nll [N]), fp32, of logits [N, V] and targets [N]."""
    if _cuda.device_of(logits, "loss") == "cpu":
        return lse_nll_plain(logits, targets)
    logits, targets = _rows(logits, targets)
    n, vocab = logits.shape
    lse, nll = (torch.empty(n, dtype=torch.float32, device=logits.device)
                for _ in range(2))
    _cuda.launch("loss_lse_nll", logits, logits.data_ptr(),
                 targets.data_ptr(), lse.data_ptr(), nll.data_ptr(), n, vocab)
    return lse, nll


def dlogits(logits, targets, lse, dnll):
    """The gradient [N, V] of sum(dnll * nll) with respect to logits [N,
    V], in the logits' dtype, from lse_nll's lse and dnll (fp32 [N]; an
    expanded gradient is copied to its N values)."""
    if _cuda.device_of(logits, "loss") == "cpu":
        return dlogits_plain(logits, targets, lse, dnll)
    logits, targets = _rows(logits, targets)
    n, vocab = logits.shape
    lse, dnll = _rows_vector(lse, n), _rows_vector(dnll, n)
    out = torch.empty_like(logits)
    _cuda.launch("loss_dlogits", logits, logits.data_ptr(),
                 targets.data_ptr(), lse.data_ptr(), dnll.data_ptr(),
                 out.data_ptr(), n, vocab)
    return out
