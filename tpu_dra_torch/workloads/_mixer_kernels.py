"""Launch the KDA layer's fused prologue and epilogue kernels
(csrc/mixer_prep.cu).

Four wrappers, one per C entry point, each with its plain PyTorch version
beside it, over bf16 activations [B, T, C] of heads 128 wide (the plain
versions take any head width):

- ``short_conv`` (``short_conv_fwd``): per channel the causal depthwise
  conv over 4 taps (w fp32 [4, C], tap 3 on the current token, no bias),
  SiLU, and with ``norm`` the L2 norm over each 128-channel head, times
  ``scale``; bf16 out.
- ``short_conv_bwd`` (``short_conv_bwd``): (dx bf16, dw fp32) of
  sum(out * dout), the forward recomputed from x.
- ``gated_norm`` (``gated_norm_fwd``): each head's RMSNorm of o times
  scale [128] and sigmoid(gate + bias) (bias fp32 [C]); bf16 out.
- ``gated_norm_bwd`` (``gated_norm_bwd``): (do, dgate, dbias, dscale) of
  sum(out * dout), do and dgate bf16, the forward recomputed.

All arithmetic is fp32; the plain versions are the same formulas in
PyTorch (their backward by autograd). The source's header says what
bounds the kernels on the H100 and what their design does about it; they
replace no TPU kernel. _cuda.py builds, loads and launches them; this
module declares the source's entry points there. For CPU tensors the
wrappers run the plain versions; for CUDA tensors they launch the kernels
on the current stream or raise. There is no other path.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads import _cuda

HEAD = 128           # the kernels' head width
TAPS = 4
KERNEL_DTYPE = torch.bfloat16

_PTR, _INT, _FLOAT = _cuda.PTR, _cuda.INT, ctypes.c_float
# The C entry points of csrc/mixer_prep.cu; each takes the stream last.
ARGTYPES = {
    # x, w, out; B, T, C, norm; scale, eps.
    "short_conv_fwd": [_PTR] * 3 + [_INT] * 4 + [_FLOAT] * 2 + [_PTR],
    # x, w, dout, dx, dw; B, T, C, norm; scale, eps.
    "short_conv_bwd": [_PTR] * 5 + [_INT] * 4 + [_FLOAT] * 2 + [_PTR],
    # o, gate, bias, scale, out; B, T, C; eps.
    "gated_norm_fwd": [_PTR] * 5 + [_INT] * 3 + [_FLOAT] + [_PTR],
    # o, gate, bias, scale, dout, do, dgate, dbias, dscale; B, T, C; eps.
    "gated_norm_bwd": [_PTR] * 9 + [_INT] * 3 + [_FLOAT] + [_PTR],
}
_cuda.declare({"mixer_prep": ARGTYPES})


# ---------------------------------------------------------------------------
# Plain PyTorch versions (fp32 arithmetic)
# ---------------------------------------------------------------------------

def short_conv_plain(x, w, norm: bool, scale: float, eps: float, head: int):
    """short_conv's function in fp32, x's dtype out."""
    b, t, c = x.shape
    xf = F.pad(x.float(), (0, 0, TAPS - 1, 0))
    y = sum(xf[:, j:j + t] * w[j].float() for j in range(TAPS))
    a = F.silu(y)
    if norm:
        a = a.view(b, t, -1, head)
        a = a * (scale * torch.rsqrt(a.square().sum(-1, keepdim=True) + eps))
    return a.reshape(b, t, c).to(x.dtype)


def gated_norm_plain(o, gate, bias, scale, eps: float):
    """gated_norm's function in fp32 (heads as wide as scale), o's dtype
    out."""
    b, t, c = o.shape
    head = scale.shape[0]
    of = o.float().view(b, t, -1, head)
    n = of * torch.rsqrt(of.square().mean(-1, keepdim=True) + eps)
    y = n * scale.float() * torch.sigmoid(
        (gate.float() + bias.float()).view(b, t, -1, head))
    return y.reshape(b, t, c).to(o.dtype)


def _plain_grads(fn, inputs, dout):
    """Autograd of fn over `inputs` (a tuple, None where no gradient is
    wanted) against dout, each gradient in its input's dtype."""
    leaves = [None if x is None else x.detach().requires_grad_()
              for x in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
        want = [x for x in leaves if x is not None]
        grads = iter(torch.autograd.grad(out.float(), want, dout.float()))
    return tuple(None if x is None else next(grads).to(x.dtype)
                 for x in leaves)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(x, name, head=HEAD):
    if head != HEAD:
        raise ValueError(f"the kernels take heads of {HEAD}, got {head}")
    if x.dtype != KERNEL_DTYPE:
        raise TypeError(f"{name} must be {KERNEL_DTYPE}, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % HEAD:
        raise ValueError(f"{name} must be [B, T, C] with C a multiple of "
                         f"{HEAD}, got {tuple(x.shape)}")
    return x.contiguous()


def _f32(x, shape):
    x = x.float().contiguous()
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"parameter of shape {tuple(x.shape)}, want {shape}")
    return x


def short_conv(x, w, norm: bool, scale: float, eps: float, head: int = HEAD):
    """SiLU(causal conv of x [B, T, C] by w [4, C]), L2-normed over each
    `head` channels and scaled where `norm`; x's dtype."""
    if _cuda.device_of(x, "short conv") == "cpu":
        return short_conv_plain(x, w, norm, scale, eps, head)
    x = _check(x, "x", head)
    b, t, c = x.shape
    w = _f32(w, (TAPS, c))
    out = torch.empty_like(x)
    _cuda.launch("short_conv_fwd", x, x.data_ptr(), w.data_ptr(),
                 out.data_ptr(), b, t, c, int(norm), scale, eps)
    return out


def short_conv_bwd(x, w, dout, norm: bool, scale: float, eps: float,
                   head: int = HEAD):
    """(dx in x's dtype, dw fp32 [4, C]) of sum(short_conv(x, w) * dout)."""
    if _cuda.device_of(x, "short conv") == "cpu":
        return _plain_grads(
            lambda x_, w_: short_conv_plain(x_, w_, norm, scale, eps, head),
            (x, w.float()), dout)
    x, dout = _check(x, "x", head), _check(dout, "dout")
    b, t, c = x.shape
    w = _f32(w, (TAPS, c))
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    _cuda.launch("short_conv_bwd", x, x.data_ptr(), w.data_ptr(),
                 dout.data_ptr(), dx.data_ptr(), dw.data_ptr(), b, t, c,
                 int(norm), scale, eps)
    return dx, dw


def gated_norm(o, gate, bias, scale, eps: float):
    """RMSNorm of each head of o [B, T, C] times scale [128] and
    sigmoid(gate + bias); o's dtype."""
    if _cuda.device_of(o, "gated norm") == "cpu":
        return gated_norm_plain(o, gate, bias, scale, eps)
    o, gate = _check(o, "o", scale.shape[0]), _check(gate, "gate")
    b, t, c = o.shape
    bias, scale = _f32(bias, (c,)), _f32(scale, (HEAD,))
    out = torch.empty_like(o)
    _cuda.launch("gated_norm_fwd", o, o.data_ptr(), gate.data_ptr(),
                 bias.data_ptr(), scale.data_ptr(), out.data_ptr(), b, t, c,
                 eps)
    return out


def gated_norm_bwd(o, gate, bias, scale, dout, eps: float):
    """(do, dgate in o's dtype, dbias fp32 [C], dscale fp32 [128]) of
    sum(gated_norm(...) * dout)."""
    if _cuda.device_of(o, "gated norm") == "cpu":
        return _plain_grads(
            lambda o_, g_, b_, s_: gated_norm_plain(o_, g_, b_, s_, eps),
            (o, gate, bias.float(), scale.float()), dout)
    o, gate, dout = (_check(x, n, scale.shape[0])
                     for x, n in ((o, "o"), (gate, "gate"), (dout, "dout")))
    b, t, c = o.shape
    bias, scale = _f32(bias, (c,)), _f32(scale, (HEAD,))
    do, dgate = torch.empty_like(o), torch.empty_like(gate)
    dbias, dscale = torch.zeros_like(bias), torch.zeros_like(scale)
    _cuda.launch("gated_norm_bwd", o, o.data_ptr(), gate.data_ptr(),
                 bias.data_ptr(), scale.data_ptr(), dout.data_ptr(),
                 do.data_ptr(), dgate.data_ptr(), dbias.data_ptr(),
                 dscale.data_ptr(), b, t, c, eps)
    return do, dgate, dbias, dscale
