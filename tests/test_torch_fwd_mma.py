"""The mma route's forward (csrc/flash_fwd.cu) on the CPU: its route and
source, its C entry's signature, and an emulation of the kernel's
arithmetic held against the JAX package's flash attention (interpret
mode) and against float64.

The kernel runs only on the card (chip_smoke.py holds it against
fwd_plain there, and reads its reproducibility). What can be rehearsed
here is its numerics. The emulation below repeats them in numpy, in the
test file only:

- fp32 products as three TF32 products of the truncation split (hi = x
  & 0xffffe000, lo = x - hi; the tensor cores read lo's top 10 mantissa
  bits), lo.hi + hi.lo + hi.hi, each mma.sync of 8 deep rounding its
  fp32 sum toward zero (tests/test_torch_bwd_mma.py's helpers);
- 64-row Q tiles against 64-key K/V tiles, ascending, causal tiles above
  the diagonal skipped, rows and keys past S zero and keys past S masked;
  each tile's keys in two halves of 32, each half with its own row max,
  row sum and accumulator;
- Q.K^T over D in the kernel's k steps (per 16-column chunk, columns 4t
  and 4t + 1 of t = 0..3, then 4t + 2 and 4t + 3), summed in one
  accumulator;
- the base-2 softmax: m the raw row max, c = fp32(scale) * fp32(log2 e),
  corr = 2^((m_old - m) c), p = 2^(fma(s, c, -m c)) on unmasked tiles and
  2^(fp32(s c) - m c) on masked ones (masked s = -1e30), each thread's
  share of the row sum fma(l, corr, sum of its 8 p) and the four shares
  added pairwise at the end;
- P split once per tile; P.V over the half's 32 keys in fresh
  accumulators (4 k steps of 8), added to the accumulator in IEEE fp32
  once per tile, with its rescale: fma(acc, corr, P.V);
- the two halves met in the kernel's order: m = max(m0, m1), w_i =
  2^((m_i - m) c), l = fma(l1, w1, l0 w0), o = fma(acc1, w1, acc0 w0) / l;
  lse = fp32(m * scale) + log(l).

bf16 (the route's D outside {64, 128}): q, k, v bf16, roped q/k rounded
to bf16, products exact, each 16-deep mma rounding toward zero, P
rounded to bf16 and P.V accumulated straight into the rescaled
accumulator, O rounded to bf16.

Tolerances: out ||diff|| / ||ref|| <= 2e-5 and lse <= 2e-5 absolute
against the reference's fp32 kernel and against float64 (chip_smoke.py's
TOL_REL_FP32 / TOL_LSE_FP32); out <= 5e-3 and lse <= 1e-4 at bf16
(TOL_REL / TOL_LSE). A cruder split (one TF32 product, or two) reads
above the fp32 bound; summing P.V straight into the accumulator instead
of per tile reads at least twice the kernel's error on the same inputs
once rows span tens of tiles. The emulation reads ~1.5e-6 at D=128, as
the card does against fwd_plain.
"""

import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_bwd_mma import _rel, _rope_np, _rz32, split_kernel, split_one
from tpu_dra.workloads import flashattention as jfa
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

TOL = 2e-5        # out (relative norm) and lse (absolute), fp32
TOL_BF16 = 5e-3   # out, bf16
TOL_LSE_BF16 = 1e-4
KEYS = 64         # keys per streamed tile (and Q rows per CTA)
HALF = 32         # keys of a tile per warp
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
        name = fk.FWD_KERNELS["mma"]
        assert name == "flash_fwd"
        assert (_cuda.CSRC / f"{name}.cu").is_file()

    def test_dispatch_covers_the_route(self):
        """The entry dispatches through flash_common.cuh's
        dispatch_head_dim (tests/test_torch_bwd_mma.py holds its cases
        against FP32_HEAD_DIMS and the bf16 head dims)."""
        source = (_cuda.CSRC / "flash_fwd.cu").read_text()
        assert "flash::dispatch<fwd::Launch>" in source

    def test_one_copy_of_the_split(self):
        """Both mma.sync kernels take the truncation split and the
        fp32 loaders from flash_common.cuh; the round-to-nearest split is
        gone."""
        common = (_cuda.CSRC / "flash_common.cuh").read_text()
        assert "0xffffe000u" in common
        assert "cvt.rna" not in common and "split_tf32" not in common
        for name in ("flash_fwd", "flash_bwd_mma"):
            source = (_cuda.CSRC / f"{name}.cu").read_text()
            assert "0xffffe000" not in source.split("#include")[1], name
            assert "flash::split(" in source, name


class TestEntrySignature:
    def test_argtypes(self):
        """q, k, v, cos, sinm, o, lse, kr pointers; B S H D Dv; q/k's
        and v's strides; causal, rope, element bytes; the stream."""
        args = fk.ARGTYPES["flash_fwd"]
        assert args[:8] == [_cuda.PTR] * 8
        assert args[8:] == fk._SHAPE + [_cuda.PTR]
        assert args[-2] is _cuda.INT

    def test_c_declaration_matches_argtypes(self):
        source = (_cuda.CSRC / "flash_fwd.cu").read_text()
        decl = re.search(r'extern "C" int flash_fwd\((.*?)\)\s*\{',
                         source, re.S).group(1)
        params = [p.strip() for p in decl.split(",")]
        kinds = {"void*": _cuda.PTR, "int": _cuda.INT, "long long": _cuda.I64}
        got = [kinds[p.rsplit(" ", 1)[0].removeprefix("const ")]
               for p in params]
        assert got == fk.ARGTYPES["flash_fwd"]
        assert [p.rsplit(" ", 1)[1] for p in params][5:8] == [
            "o", "lse", "kr"]


def _operands(s, d, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal((B, s, H, d)).astype(np.float32)
                 for _ in range(3))


def _bf16(x):
    """x rounded to bf16 (nearest even), as fp32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _exp2(x):
    return _f32(np.exp2(np.asarray(x, np.float64)))


def _fma(a, b, c):
    """fp32 fma(a, b, c): the exact a * b (48 bits fit a float64) plus c,
    rounded to fp32."""
    return _f32(np.asarray(a, np.float64) * b + np.asarray(c, np.float64))


def _qk_steps(d):
    """The kernel's k steps of Q.K^T: per 16-column chunk, columns 4t and
    4t + 1 of t = 0..3, then 4t + 2 and 4t + 3."""
    steps = []
    for c0 in range(0, d, 16):
        base = c0 + 4 * np.arange(4)
        steps += [np.concatenate([base, base + 1]),
                  np.concatenate([base + 2, base + 3])]
    return steps


def _mma(c, a, b, steps, split, terms):
    """c += a . b (a [..., M, K], b [..., K, N]) over the k steps
    `steps` (column sets of 8), each step's products lo.hi, hi.lo, hi.hi
    (the last `terms` of them) added one at a time and rounded toward
    zero. split None: bf16 operands, one exact product per step."""
    if split is None:
        pairs = [(a, b)]
    else:
        (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
        pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - terms:]
    for ks in steps:
        for x, y in pairs:
            prod = x[..., ks].astype(np.float64) @ y[..., ks, :]
            c = _rz32(c.astype(np.float64) + prod)
    return c


def emulate_fwd(q, k, v, tables, causal, bf16=False, split=split_kernel,
                terms=3, per_tile=True):
    """(o [BH, S, D], lse [BH, S]) fp32: flash_fwd's arithmetic on [BH, S,
    D] inputs (module docstring). bf16: the inputs hold bf16 values and
    the bf16 instance is emulated. per_tile=False sums fp32 P.V straight
    into the accumulator."""
    bh, s, d = q.shape
    if tables is not None:
        q, k = (_rope_np(x, *tables) for x in (q, k))
        if bf16:
            q, k = _bf16(q), _bf16(k)
    n = -(-s // KEYS) * KEYS

    def pad(x):
        return np.pad(x, [(0, 0), (0, n - s), (0, 0)])

    q, k, v = (pad(x) for x in (q, k, v))
    scale = np.float32(1.0 / math.sqrt(d))
    c2 = np.float32(scale * np.float32(1.4426950408889634))
    depth = 16 if bf16 else 8
    qk_steps = ([np.arange(i, i + 16) for i in range(0, d, 16)] if bf16
                else _qk_steps(d))
    pv_steps = [np.arange(i, i + depth) for i in range(0, HALF, depth)]
    mma_split = None if bf16 else split
    o = np.zeros((bh, n, d), np.float32)
    lse = np.zeros((bh, n), np.float32)
    for q0 in range(0, n, KEYS):
        rows = np.arange(q0, q0 + KEYS)
        parts = []
        for half in (0, 1):
            m = np.full((bh, KEYS), -1e30, np.float32)
            l = np.zeros((bh, KEYS, 4), np.float32)   # per thread t
            acc = np.zeros((bh, KEYS, d), np.float32)
            for k0 in range(0, q0 + KEYS if causal else n, KEYS):
                keys = k0 + half * HALF + np.arange(HALF)
                sc = _mma(np.zeros((bh, KEYS, HALF), np.float32), q[:, rows],
                          np.swapaxes(k[:, keys], 1, 2), qk_steps, mma_split,
                          terms)
                masked = (causal and k0 == q0) or k0 + KEYS > s
                drop = keys[None, :] >= s
                if causal:
                    drop = drop | (keys[None, :] > rows[:, None])
                sc = np.where(drop, np.float32(-1e30), sc)
                mx = np.maximum(m, sc.max(-1))
                corr = _exp2(_f32(m - mx) * c2)
                mc = _f32(mx * c2)
                if masked:
                    p = _exp2(_f32(sc * c2) - mc[..., None])
                else:
                    p = _exp2(_fma(sc, c2, -mc[..., None]))
                # Thread t sums columns 8j + 2t and 8j + 2t + 1, j = 0..3.
                pairs = _f32(p[..., 0::2] + p[..., 1::2]).reshape(
                    bh, KEYS, 4, 4)
                rs = pairs[..., 0, :]
                for j in range(1, 4):
                    rs = _f32(rs + pairs[..., j, :])
                l = _fma(l, corr[..., None], rs)
                m = mx
                if per_tile and not bf16:
                    tile = _mma(np.zeros_like(acc), p, v[:, keys], pv_steps,
                                split, terms)
                    acc = _fma(acc, corr[..., None], tile)
                else:
                    acc = _mma(_f32(acc * corr[..., None]),
                               _bf16(p) if bf16 else p, v[:, keys], pv_steps,
                               None if bf16 else split, 1 if bf16 else terms)
            l = _f32(_f32(l[..., 0] + l[..., 1]) + _f32(l[..., 2] + l[..., 3]))
            parts.append((m, l, acc))
        (m0, l0, a0), (m1, l1, a1) = parts
        m = np.maximum(m0, m1)
        w0, w1 = _exp2(_f32(m0 - m) * c2), _exp2(_f32(m1 - m) * c2)
        l = _fma(l1, w1, _f32(l0 * w0))
        o[:, rows] = _f32(_fma(a1, w1[..., None], _f32(a0 * w0[..., None]))
                          / l[..., None])
        lse[:, rows] = _f32(_f32(m * scale) + _f32(np.log(l)))
    o, lse = o[:, :s], lse[:, :s]
    return (_bf16(o) if bf16 else o), lse


def _float64_forward(q, k, v, tables, causal):
    """(o, lse) of attention in float64 on [BH, S, D] inputs."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    if tables is not None:
        cos_t, sinm_t = (t.astype(np.float64) for t in tables)
        q, k = (x * cos_t + np.roll(x, x.shape[-1] // 2, axis=-1) * sinm_t
                for x in (q, k))
    s, d = q.shape[1], q.shape[2]
    scores = q @ np.swapaxes(k, 1, 2) / math.sqrt(d)
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    mx = scores.max(-1, keepdims=True)
    p = np.exp(scores - mx)
    return p @ v / p.sum(-1)[..., None], mx[..., 0] + np.log(p.sum(-1))


def _bh(x):   # [B, S, H, D] -> [B*H, S, D]
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _case(s, d, causal, rope, seed, bf16=False, reference=True, **emu):
    """(emulation, reference in interpret mode or None, float64) as
    [BH, S, D] and [BH, S] arrays; bf16 inputs where `bf16`."""
    q, k, v = _operands(s, d, seed)
    if bf16:
        q, k, v = (_bf16(x) for x in (q, k, v))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = None
    if reference:
        blocks = {} if causal else {"block_q": s, "block_k": s}
        ref_o, ref_l = jfa.flash_attention_with_lse(
            *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), causal=causal,
            rope=rope, interpret=True, **blocks)
        ref = (_bh(np.asarray(ref_o, np.float32)),
               np.asarray(ref_l, np.float32).reshape(B * H, s))
    tables = None
    if rope:   # the reference's own tables: the same inputs
        tables, _ = jfa._rope_operands(s, d, True, jnp.dtype(jdt))
        tables = tuple(np.asarray(t, np.float32) for t in tables)
    q, k, v = (_bh(x) for x in (q, k, v))
    got = emulate_fwd(q, k, v, tables, causal, bf16=bf16, **emu)
    return got, ref, _float64_forward(q, k, v, tables, causal)


def _errs(got, want):
    return {"out": _rel(got[0], want[0]),
            "lse": float(np.abs(np.asarray(got[1], np.float64)
                                - want[1]).max())}


class TestEmulatedArithmetic:
    @pytest.mark.parametrize("rope", [True, False])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", [16, 128])
    @pytest.mark.parametrize("s", [40, 320])
    def test_fp32_within_tolerance(self, s, d, causal, rope):
        got, ref, exact = _case(s, d, causal, rope,
                                seed=80 + s + d + 2 * causal + rope)
        for against in (ref, exact):
            errs = _errs(got, against)
            assert errs["out"] <= TOL and errs["lse"] <= TOL, errs

    @pytest.mark.parametrize("causal,rope", [(True, True), (False, False)])
    @pytest.mark.parametrize("s", [40, 320])
    def test_bf16_d32_within_tolerance(self, s, causal, rope):
        got, ref, _ = _case(s, 32, causal, rope, seed=90 + s + causal,
                            bf16=True)
        errs = _errs(got, ref)
        assert errs["out"] <= TOL_BF16 and errs["lse"] <= TOL_LSE_BF16, errs

    @pytest.mark.parametrize("crude", [
        dict(split=split_one),        # one TF32 product
        dict(terms=2),                # a_lo.b_hi dropped too
    ], ids=["one_product", "two_products"])
    def test_cruder_split_reads_above_tolerance(self, crude):
        got, _, exact = _case(320, 128, True, True, seed=81,
                              reference=False, **crude)
        assert _errs(got, exact)["out"] > TOL

    def test_per_tile_sums_matter(self):
        """Summing P.V straight into the accumulator, each mma rounding
        the whole running sum toward zero, reads at least twice the
        kernel's error once rows sum over tens of tiles (S=2048: 32; the
        fp32 model's S=8192 sums over 128): the emulation sees the
        per-tile IEEE adds the kernel makes."""
        kernel, _, exact = _case(2048, 16, True, True, seed=82,
                                 reference=False)
        crude, _, _ = _case(2048, 16, True, True, seed=82, reference=False,
                            per_tile=False)
        assert _rel(crude[0], exact[0]) > 2 * _rel(kernel[0], exact[0])
