"""The mma route's fused backward (csrc/flash_bwd_mma.cu) on the CPU: its
route and sources, its C entry's signature, the ``bwd`` wrapper's CPU
path against the JAX package's fp32 backward (interpret mode), and an
emulation of the kernel's fp32 arithmetic against a float64 backward.

The kernel runs only on the card (chip_smoke.py holds it against
bwd_plain there, and reads its reproducibility). What can be rehearsed
here is its numerics. The emulation below repeats them in numpy, in the
test file only:

- the split: hi = x & 0xffffe000 (x truncated to TF32), lo = x - hi
  (exact in fp32); the tensor cores read the top 10 mantissa bits of
  each operand, and each product runs as lo.hi + hi.lo + hi.hi (lo.lo
  dropped), each mma.sync of 8 deep rounding its fp32 sum toward zero;
- 64-key K/V tiles stay put while the 64-row Q/dO tiles that attend to
  them stream past, from the diagonal's tile when causal; rows past S
  are zero and masked;
- per tile S^T = K.Q^T and dP^T = V.dO^T summed over D in one
  accumulator; P^T = exp(s * scale - lse), dS^T = P^T * (dP^T + dlse -
  delta) in fp32;
- dV += P^T.dO and dK += dS^T.Q over each half of a tile's queries in
  fresh accumulators, added in IEEE fp32 to the half's running sum; the
  two halves added at the end;
- the dQ partial dS.K over the tile's 64 keys in fresh accumulators,
  added in fp32 into one accumulator, K tile by K tile in ascending order
  (the kernel's atomics add them in no fixed order: fp32 rounding only);
- dK and dQ scaled and inverse-rotated in fp32 once.

Tolerances: ||diff|| / ||ref|| <= 2e-5 against the JAX reference's fp32
backward and against float64 (chip_smoke.py's TOL_REL_FP32, the
reference's fp32 kernel bound). The split drops at most ~3 * 2^-20 of a
product, and the tensor cores' truncating accumulation most of the rest:
the emulation reads ~4e-6 at D=128, as the card does. A cruder split
(one TF32 product, or two) drops ~2^-10 and must read above the bound; a
lo part kept to 7 bits reads within it, at more than twice the kernel's
error.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_dra.workloads import flashattention as jfa
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

TOL = 2e-5
KEYS = 64      # keys per CTA
ROWS = 64      # queries per streamed tile
HALF = 32      # queries of a tile per warp
S_TEST = 200
B, H = 1, 2
# What the mma route serves: fp32 at FP32_HEAD_DIMS, bf16 at every other
# multiple of 16 up to MAX_HEAD_DIM.
MMA_INPUTS = ([(torch.float32, d) for d in fk.FP32_HEAD_DIMS]
              + [(torch.bfloat16, d)
                 for d in range(16, fk.MAX_HEAD_DIM + 1, 16)
                 if d not in fk.SM90_HEAD_DIMS])


class TestRoute:
    @pytest.mark.parametrize("dtype,d", MMA_INPUTS)
    def test_route_and_source(self, dtype, d):
        assert fk.route(dtype, d) == "mma"
        name = fk.BWD_KERNELS["mma"]
        assert name == "flash_bwd_mma"
        assert (_cuda.CSRC / f"{name}.cu").is_file()

    def test_pair_is_gone(self):
        """The dq/dkv pair left with its sources, entries and wrappers."""
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert not (_cuda.CSRC / f"{name}.cu").exists()
            assert name not in fk.ARGTYPES
            assert not hasattr(fk, name.removeprefix("flash_"))

    def test_dispatch_covers_the_route(self):
        """The entry dispatches through flash_common.cuh's
        dispatch_head_dim, whose cases are the head dims the wrapper lets
        through: FP32_HEAD_DIMS in fp32, every multiple of 16 in bf16."""
        common = (_cuda.CSRC / "flash_common.cuh").read_text()
        body = common[common.index("cudaError_t dispatch_head_dim"):
                      common.index("// Dispatch on (element type, D)")]
        fp32, bf16 = body.split("} else {")
        cases = [sorted(int(x) for x in re.findall(r"case (\d+):", part))
                 for part in (fp32, bf16)]
        assert cases[0] == list(fk.FP32_HEAD_DIMS)
        assert cases[1] == list(range(16, fk.MAX_HEAD_DIM + 1, 16))
        source = (_cuda.CSRC / "flash_bwd_mma.cu").read_text()
        assert "flash::dispatch<bwd_mma::Launch>" in source


class TestEntrySignature:
    def test_argtypes(self):
        """q, k, v, dout, lse, delta, dlse, cos, sinm, dq_acc, dq, dk, dv
        pointers; B S H D Dv; q/k's and v's strides; causal, rope,
        element bytes; the stream."""
        args = fk.ARGTYPES["flash_bwd_mma"]
        assert args[:13] == [_cuda.PTR] * 13
        assert args[13:] == fk._SHAPE + [_cuda.PTR]
        assert args[-2] is _cuda.INT

    def test_c_declaration_matches_argtypes(self):
        source = (_cuda.CSRC / "flash_bwd_mma.cu").read_text()
        decl = re.search(r'extern "C" int flash_bwd_mma\((.*?)\)\s*\{',
                         source, re.S).group(1)
        params = [p.strip() for p in decl.split(",")]
        kinds = {"void*": _cuda.PTR, "int": _cuda.INT, "long long": _cuda.I64}
        got = []
        for p in params:
            typ = p.rsplit(" ", 1)[0].removeprefix("const ")
            got.append(kinds[typ])
        assert got == fk.ARGTYPES["flash_bwd_mma"]
        assert [p.rsplit(" ", 1)[1] for p in params][9:13] == [
            "dq_acc", "dq", "dk", "dv"]


def _operands(s, d, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    q, k, v, dout = (rs.standard_normal((B, s, H, d)).astype(np.float32)
                     for _ in range(4))
    dlse = (rs.standard_normal((B, H, s)) * 0.1).astype(np.float32)
    return q, k, v, dout, dlse


class TestCpuPath:
    @pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                         (torch.bfloat16, 48)])
    def test_launches_nothing(self, dtype, d):
        q, k, v, dout, dlse = (torch.from_numpy(x)
                               for x in _operands(96, d, seed=5))
        q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
        tables = tfa._rope_operands(96, d, dtype, torch.device("cpu"))
        o, lse = fk.fwd(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        _cuda.reset_launches()
        dq, dk, dv = fk.bwd(q, k, v, dout, lse, delta, dlse, tables,
                            causal=True)
        assert dq.dtype == dk.dtype == dv.dtype == dtype
        launches = _cuda.launches()
        assert {name: launches[name] for name in fk.ARGTYPES} == {
            "flash_fwd_sm90": 0, "flash_fwd": 0, "flash_bwd_sm90": 0,
            "flash_bwd_mma": 0}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_reference(q, k, v, dout, dlse, causal, rope):
    """The JAX package's fp32 flash attention (interpret mode) and its
    gradients for cotangents (dout, dlse): (out, lse, dq, dk, dv) as
    numpy, [B, S, H, D] and [B, H, S]."""
    s = q.shape[1]
    blocks = {} if causal else {"block_q": s, "block_k": s}

    def f(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            rope=rope, interpret=True,
                                            **blocks)

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    return tuple(np.asarray(x, np.float32) for x in (out, lse, *grads))


class TestAgainstReference:
    @pytest.mark.parametrize("rope", [True, False])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", [16, 128])
    def test_fp32_backward(self, d, causal, rope):
        """fk.bwd on CPU tensors (the plain version the kernel is held
        against on the card) against the reference's backward rule."""
        q, k, v, dout, dlse = _operands(S_TEST, d, seed=40 + d + 2 * causal
                                        + rope)
        want = _jax_reference(q, k, v, dout, dlse, causal, rope)
        tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
        tables = (tfa._rope_operands(S_TEST, d, torch.float32,
                                     torch.device("cpu")) if rope else None)
        o, lse = fk.fwd(tq, tk, tv, tables, causal=causal)
        delta = (tdo * o).sum(-1).transpose(1, 2)
        got = (o, lse, *fk.bwd(tq, tk, tv, tdo, lse, delta,
                               torch.from_numpy(dlse), tables,
                               causal=causal))
        for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            assert g.shape == w.shape, name
            assert _rel(g.numpy(), w) <= TOL, f"{name} {_rel(g.numpy(), w)}"


# ---------------------------------------------------------------------------
# The kernel's fp32 arithmetic in numpy
# ---------------------------------------------------------------------------

MASK = np.uint32(0xffffe000)


def _tf32(x):
    """What the tensor cores read of an fp32 operand: its top 10
    mantissa bits (truncation)."""
    return (np.asarray(x, np.float32).view(np.uint32) & MASK).view(np.float32)


def split_kernel(x):
    """flash_bwd_mma.cu's split: (hi, lo) as the tensor cores read them."""
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def split_one(x):
    """One TF32 product: no lo part."""
    return _tf32(x), np.zeros_like(x, np.float32)


def split_lo_bf16(x):
    """lo kept to 7 mantissa bits only (a bf16-wide low part)."""
    hi = _tf32(x)
    lo = np.asarray(x, np.float32) - hi
    return hi, (lo.view(np.uint32) & np.uint32(0xffff0000)).view(np.float32)


def _rz32(x):
    """float64 -> fp32, rounded toward zero (the tensor cores' fp32
    accumulation)."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma3(c, a, b, split, terms=3):
    """c += a . b (a [..., M, K], b [..., K, N], K a multiple of 8) as the
    kernel's mma.sync steps: per 8-deep step lo.hi, hi.lo, hi.hi, each
    rounding its fp32 sum toward zero (`terms` 2 drops hi.lo as well)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - terms:]
        for x, y in pairs:
            prod = x[..., ks].astype(np.float64) @ y[..., ks, :]
            c = _rz32(c.astype(np.float64) + prod)
    return c


def _rope_np(x, cos_t, sinm_t, inverse=False):
    """x [..., S, D] fp32 rotated as rope_rotate: x * cos + roll(x) * sinm
    in fp32, (-sinm) for the inverse."""
    s = -sinm_t if inverse else sinm_t
    rolled = np.roll(x, x.shape[-1] // 2, axis=-1)
    return (x * cos_t + rolled * s).astype(np.float32)


def emulate_bwd_mma(q, k, v, dout, lse, delta, dlse, tables, causal,
                    split=split_kernel, terms=3):
    """(dq, dk, dv) [BH, S, D] fp32: flash_bwd_mma's fp32 arithmetic on
    [BH, S, D] fp32 inputs, lse/delta/dlse [BH, S] (module docstring)."""
    bh, s, d = q.shape
    if tables is not None:
        q, k = (_rope_np(x, *tables) for x in (q, k))
    n = -(-s // KEYS) * KEYS

    def pad(x):
        return np.pad(x, [(0, 0), (0, n - s)] + [(0, 0)] * (x.ndim - 2))

    q, k, v, dout, lse, delta, dlse = (pad(x) for x in
                                       (q, k, v, dout, lse, delta, dlse))
    scale = np.float32(1.0 / math.sqrt(d))
    corr = (dlse - delta).astype(np.float32)
    dq_acc = np.zeros((bh, n, d), np.float32)
    dk_half = np.zeros((2, bh, n, d), np.float32)
    dv_half = np.zeros((2, bh, n, d), np.float32)
    for k0 in range(0, n, KEYS):
        keys = np.arange(k0, k0 + KEYS)
        for q0 in range(k0 if causal else 0, n, ROWS):
            qs = np.arange(q0, q0 + ROWS)
            zero = np.zeros((bh, KEYS, ROWS), np.float32)
            kq = np.swapaxes(q[:, qs], 1, 2)
            st = _mma3(zero, k[:, keys], kq, split, terms)
            dpt = _mma3(zero, v[:, keys], np.swapaxes(dout[:, qs], 1, 2),
                        split, terms)
            sc = st * scale
            drop = (keys[:, None] >= s) | (qs[None, :] >= s)
            if causal:
                drop = drop | (qs[None, :] < keys[:, None])
            sc = np.where(drop, np.float32(-1e30), sc)
            p = np.exp(sc - lse[:, None, qs]).astype(np.float32)
            ds = (p * (dpt + corr[:, None, qs])).astype(np.float32)
            for half in range(2):
                hs = slice(half * HALF, (half + 1) * HALF)
                fresh = np.zeros((bh, KEYS, d), np.float32)
                dv_half[half][:, keys] += _mma3(
                    fresh, p[..., hs], dout[:, qs[hs]], split, terms)
                dk_half[half][:, keys] += _mma3(
                    fresh, ds[..., hs], q[:, qs[hs]], split, terms)
            fresh = np.zeros((bh, ROWS, d), np.float32)
            dq_acc[:, qs] += _mma3(fresh, np.swapaxes(ds, 1, 2),
                                   k[:, keys], split, terms)
    dq = dq_acc[:, :s] * scale
    dk = (dk_half[0] + dk_half[1])[:, :s] * scale
    dv = (dv_half[0] + dv_half[1])[:, :s]
    if tables is not None:
        dq, dk = (_rope_np(x, *tables, inverse=True) for x in (dq, dk))
    return dq, dk, dv


def _float64_backward(q, k, v, dout, dlse, tables, causal):
    """(lse, delta, dq, dk, dv) of attention in float64 on [BH, S, D]
    inputs: the exact function the kernel computes."""
    q, k, v, dout = (x.astype(np.float64) for x in (q, k, v, dout))
    if tables is not None:
        cos_t, sinm_t = (t.astype(np.float64) for t in tables)
        rot = (lambda x, s: x * cos_t
               + np.roll(x, x.shape[-1] // 2, axis=-1) * s)
        q, k = rot(q, sinm_t), rot(k, sinm_t)
    s, d = q.shape[1], q.shape[2]
    scores = q @ np.swapaxes(k, 1, 2) / math.sqrt(d)
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) \
        + scores.max(-1)
    p = np.exp(scores - lse[..., None])
    out = p @ v
    delta = (dout * out).sum(-1)
    dp = dout @ np.swapaxes(v, 1, 2)
    ds = p * (dp - delta[..., None] + dlse[..., None])
    dq = ds @ k / math.sqrt(d)
    dk = np.swapaxes(ds, 1, 2) @ q / math.sqrt(d)
    dv = np.swapaxes(p, 1, 2) @ dout
    if tables is not None:
        dq, dk = rot(dq, -sinm_t), rot(dk, -sinm_t)
    return lse, delta, dq, dk, dv


def _emulation_case(d, causal, rope, seed, **emu):
    q, k, v, dout, dlse = _operands(S_TEST, d, seed)

    def bh(x):   # [B, S, H, D] -> [B*H, S, D]
        return x.transpose(0, 2, 1, 3).reshape(B * H, S_TEST, d)

    q, k, v, dout = (bh(x) for x in (q, k, v, dout))
    dlse = dlse.reshape(B * H, S_TEST).astype(np.float64)
    tables = None
    if rope:
        tables = tuple(t.numpy() for t in tfa._rope_operands(
            S_TEST, d, torch.float32, torch.device("cpu")))
    lse, delta, *want = _float64_backward(q, k, v, dout, dlse, tables,
                                          causal)
    # The kernel's lse and delta come from the forward in fp32.
    got = emulate_bwd_mma(q, k, v, dout, lse.astype(np.float32),
                          delta.astype(np.float32),
                          dlse.astype(np.float32), tables, causal, **emu)
    return {name: _rel(g, w) for name, g, w in
            zip(("dq", "dk", "dv"), got, want)}


class TestEmulatedArithmetic:
    @pytest.mark.parametrize("rope", [True, False])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", [16, 128])
    def test_within_fp32_tolerance(self, d, causal, rope):
        errs = _emulation_case(d, causal, rope, seed=70 + d + 2 * causal
                               + rope)
        assert max(errs.values()) <= TOL, errs

    @pytest.mark.parametrize("crude", [
        dict(split=split_one),        # one TF32 product
        dict(terms=2),                # a_lo.b_hi dropped too
    ], ids=["one_product", "two_products"])
    def test_cruder_split_reads_above_tolerance(self, crude):
        errs = _emulation_case(128, True, True, seed=71, **crude)
        assert max(errs.values()) > TOL, errs

    def test_lo_bits_matter(self):
        """A lo part kept to 7 bits stays within the bound, but reads at
        least twice the kernel's error on the same inputs: the emulation
        sees every bit of the split the kernel keeps."""
        kernel = _emulation_case(128, True, True, seed=71)
        crude = _emulation_case(128, True, True, seed=71,
                                split=split_lo_bf16)
        assert all(crude[n] > 2 * kernel[n] for n in kernel), (crude, kernel)

    def test_truncation_costs_less_than_tolerance(self):
        """The truncating split's error sits well inside the bound: the
        kernel's numbers leave room for summation order on the card."""
        errs = _emulation_case(128, True, True, seed=72)
        assert max(errs.values()) <= TOL / 3, errs
