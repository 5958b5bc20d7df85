"""The Hopper forward (csrc/flash_fwd_sm90.cu) on the CPU: its route, its
C entry's signature, the rope-table structure it relies on, and an
emulation of its arithmetic held against the JAX package's flash
attention (interpret mode).

The kernel runs only on the card (chip_smoke.py holds it against
fwd_plain there). What can be rehearsed here is its numerics: the
emulation below repeats them step by step in PyTorch on the CPU, in the
test file only:

- 128-row Q tiles against 128-key K/V tiles, ascending, causal tiles
  above the diagonal skipped, rows and keys past S zero (TMA's fill),
  keys past S masked in every mode;
- q and k rotated from the first halves of the tables (cos_t's second
  half repeats its first, sinm_t's is its negation), x * c + y * s in
  fp32 and rounded to bf16;
- scores scaled after the dot by sm_scale * log2(e) (an fp32 product),
  masked scores -1e30, p = 2^(s - m) with m in base 2;
- unnormalised p rounded to bf16 before P.V, the denominator summing
  fp32 p, O divided by it and then rounded; lse = m * ln(2) + log(l).

Tolerances against the reference (bf16 inputs): out ||diff|| / ||ref||
<= 5e-3 (chip_smoke.py's kernel bound: bf16 output rounding and P rounded
per tile on one side, per block on the other) and lse <= 1e-4 absolute
(fp32 sums in another order).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_dra.workloads import flashattention as jfa
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

TILE = 128
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


class TestRoute:
    @pytest.mark.parametrize("d", fk.FWD_SM90_HEAD_DIMS)
    def test_bf16_at_sm90_head_dims(self, d):
        assert fk.fwd_route(torch.bfloat16, d) == "sm90"

    @pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
    def test_bf16_at_other_head_dims(self, d):
        assert fk.fwd_route(torch.bfloat16, d) == "mma"

    @pytest.mark.parametrize("d", fk.FP32_HEAD_DIMS)
    def test_fp32_keeps_mma(self, d):
        assert fk.fwd_route(torch.float32, d) == "mma"

    def test_each_route_names_a_source(self):
        assert fk.FWD_KERNELS == {"sm90": "flash_fwd_sm90", "mma": "flash_fwd"}
        for name in fk.FWD_KERNELS.values():
            assert (fk.CSRC / f"{name}.cu").is_file()

    @pytest.mark.parametrize("dtype,d,match", [
        (torch.bfloat16, 144, "head dim"),        # past MAX_HEAD_DIM
        (torch.bfloat16, 24, "head dim"),         # not a multiple of 16
        (torch.float32, 64, "fp32 kernels are built"),
        (torch.float16, 128, "bfloat16 or float32"),
    ])
    def test_refusals_unchanged(self, dtype, d, match):
        """What the wrappers refuse still raises before any route."""
        q = torch.zeros(1, 64, 1, d, dtype=dtype)
        with pytest.raises((ValueError, TypeError), match=match):
            fk._kernel_inputs(q, q, q, None)

    def test_cpu_path_counts_no_kernel(self):
        fk.reset_launches()
        q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
        fk.fwd(q, q, q, None, causal=True)
        assert fk.kernel_launches() == {"flash_fwd_sm90": 0, "flash_fwd": 0,
                                        "flash_bwd_sm90": 0, "flash_bwd_dq": 0,
                                        "flash_bwd_dkv": 0}


class TestEntrySignature:
    def test_same_c_interface_as_flash_fwd(self):
        """q, k, v, cos, sinm, o, lse pointers; B S H D; three strides;
        causal, rope, element bytes; the stream."""
        assert fk.ARGTYPES["flash_fwd_sm90"] == fk.ARGTYPES["flash_fwd"]
        args = fk.ARGTYPES["flash_fwd_sm90"]
        assert args[:7] == [fk._PTR] * 7 and args[-1] is fk._PTR
        assert args[-2] is fk._INT   # element bytes

    def test_every_source_has_argtypes(self):
        assert {p.stem for p in fk.CSRC.glob("*.cu")} == set(fk.ARGTYPES)


class TestRopeTableHalves:
    """The kernel reads only the first D/2 columns of each table."""

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("s,d", [(40, 64), (300, 128), (16384, 128)])
    def test_second_halves_follow_the_first(self, s, d, dtype):
        cos_t, sinm_t = tfa._rope_operands(s, d, dtype, torch.device("cpu"))
        half = d // 2
        assert torch.equal(cos_t[:, half:], cos_t[:, :half])
        assert torch.equal(sinm_t[:, half:], -sinm_t[:, :half])


def _rotate_from_halves(x, cos_half, sinm_half):
    """x [B, S, H, D] rotated as the kernel does: from the tables' first
    halves, x * c + y * s in fp32, rounded to x.dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    lo, hi = xf[..., :half], xf[..., half:]
    c, s = cos_half[:, None, :].float(), sinm_half[:, None, :].float()
    return torch.cat([lo * c + hi * s, hi * c + lo * (-s)], -1).to(x.dtype)


def emulate_sm90(q, k, v, tables, causal):
    """(o [B, S, H, D] bf16, lse [B, H, S] fp32): flash_fwd_sm90's
    arithmetic on bf16 [B, S, H, D] inputs (module docstring)."""
    b, s, h, d = q.shape
    if tables is not None:
        cos_half, sinm_half = (t[:, : d // 2] for t in tables)
        q = _rotate_from_halves(q, cos_half, sinm_half)
        k = _rotate_from_halves(k, cos_half, sinm_half)
    n = -(-s // TILE)
    pad = n * TILE - s

    def heads(x):   # [B, S, H, D] -> [B*H, n*TILE, D] fp32, zero rows past S
        x = x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale_log2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    o = torch.empty(b * h, n * TILE, d)
    lse = torch.empty(b * h, n * TILE)
    cols = torch.arange(TILE)
    for qt in range(n):
        rows = qt * TILE + torch.arange(TILE)
        m = torch.full((b * h, TILE), -1e30)
        l = torch.zeros(b * h, TILE)
        acc = torch.zeros(b * h, TILE, d)
        for kt in range(qt + 1 if causal else n):
            keys = kt * TILE + cols
            sc = qh[:, rows] @ kh[:, keys].transpose(1, 2)
            x = sc * scale_log2
            drop = keys[None, :] >= s
            if causal:
                drop = drop | (keys[None, :] > rows[:, None])
            x = x.masked_fill(drop, -1e30)
            mx = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] \
                + p.to(torch.bfloat16).float() @ vh[:, keys]
            m = mx
        o[:, rows] = acc / l[..., None]
        lse[:, rows] = m * LN2 + torch.log(l)
    o = o[:, :s].reshape(b, h, s, d).permute(0, 2, 1, 3).to(torch.bfloat16)
    return o, lse[:, :s].reshape(b, h, s)


class TestEmulatedArithmetic:
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("s", [40, 300])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("rope", [True, False])
    def test_against_reference(self, s, d, causal, rope):
        rs = np.random.RandomState(1000 + s + d + 2 * causal + rope)
        q, k, v = (rs.standard_normal((1, s, 2, d)).astype(np.float32)
                   for _ in range(3))
        blocks = {} if causal else {"block_q": s, "block_k": s}
        want_o, want_l = jfa.flash_attention_with_lse(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
            causal=causal, rope=rope, interpret=True, **blocks)
        tables = None
        if rope:   # the reference's own bf16 tables: the same inputs
            (cos_t, sinm_t), _ = jfa._rope_operands(s, d, True,
                                                    jnp.dtype("bfloat16"))
            tables = tuple(torch.from_numpy(np.array(t, np.float32))
                           .to(torch.bfloat16) for t in (cos_t, sinm_t))
            half = d // 2
            assert torch.equal(tables[0][:, half:], tables[0][:, :half])
            assert torch.equal(tables[1][:, half:], -tables[1][:, :half])
        got_o, got_l = emulate_sm90(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
            tables, causal)
        ref_o = torch.from_numpy(np.array(want_o, np.float32))
        out_rel = float((got_o.float() - ref_o).norm() / ref_o.norm())
        lse_abs = float((got_l - torch.from_numpy(
            np.array(want_l, np.float32))).abs().max())
        assert out_rel <= 5e-3, out_rel
        assert lse_abs <= 1e-4, lse_abs

    def test_matches_plain_version(self):
        """The emulation and fwd_plain (the kernel's yardstick on the
        card) agree as chip_smoke.py requires of the kernel."""
        rs = np.random.RandomState(7)
        q, k, v = (torch.from_numpy(rs.standard_normal((2, 300, 2, 128))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(3))
        tables = tfa._rope_operands(300, 128, torch.bfloat16,
                                    torch.device("cpu"))
        got_o, got_l = emulate_sm90(q, k, v, tables, True)
        want_o, want_l = fk.fwd_plain(q, k, v, tables, causal=True)
        out_rel = float((got_o.float() - want_o.float()).norm()
                        / want_o.float().norm())
        assert out_rel <= 5e-3, out_rel
        assert float((got_l - want_l).abs().max()) <= 1e-4
