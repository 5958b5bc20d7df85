"""The matrix product the reference computes in, by precision.

- "fp32": float32 with TF32 off (``fp32_matmuls`` sets it), the
  reference itself.
- "fp8": the control. Both operands of every product are rounded to
  float8 e4m3 with a per-tensor scale (amax to the format's largest
  value), the product accumulated in float32; in the backward the
  incoming gradient is rounded to e5m2 the same way. That is the step
  below the bf16 the configurations state, which a later change could be
  tempted to take.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "fp8")
_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0),
            "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def fp32_matmuls():
    """Full float32 products (TF32 off) inside, the settings restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def quantize(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """x rounded to the float8 format `fmt` under a per-tensor scale,
    returned in float32."""
    dtype, top = _FORMATS[fmt]
    scale = top / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x.float() * scale).to(dtype).float() / scale


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    while x.dim() > len(shape):
        x = x.sum(0)
    return x


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, "e4m3"), quantize(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = quantize(grad, "e5m2")
        ga = qg @ qb.transpose(-1, -2)
        gb = _sum_to(qa.transpose(-1, -2) @ qg, qb.shape)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(a, b)


def matmul(precision: str):
    """The product a @ b of `precision`."""
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return fp8_matmul
    raise ValueError(f"unknown precision {precision!r} (have {PRECISIONS})")
