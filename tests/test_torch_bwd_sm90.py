"""The fused Hopper backward (csrc/flash_bwd_sm90.cu) on the CPU: its
C entry's signature (its route: tests/test_torch_fwd_sm90.py, which holds
both directions'), the ``bwd`` wrapper's CPU path, and an
emulation of its arithmetic held against the JAX package's flash
backward (``_flash_bwd_rule``, interpret mode).

The kernel runs only on the card (chip_smoke.py holds it against
bwd_dq_plain and bwd_dkv_plain there). What can be rehearsed here is its
numerics: the emulation below repeats them step by step in PyTorch on
the CPU, in the test file only:

- 128-key K/V tiles stay put while the 64-row Q/dO tiles that attend to
  them stream past in ascending order, from the diagonal's tile when
  causal; rows and keys past S are zero (TMA's fill) and masked in every
  mode;
- q and k rotated from the first halves of the tables, x * c + y * s in
  fp32 and rounded to bf16;
- P^T = 2^(s * sm_scale * log2(e) - lse * log2(e)), masked entries 0;
  dP^T = V.dO^T; dS^T = P^T * (dP^T + dlse - delta);
- per Q tile dV += bf16(P)^T.dO and dK += bf16(dS)^T.Q in fp32, and the
  dQ partial bf16(dS).K added in fp32 into one accumulator, K tile by K
  tile in ascending order (the kernel's atomics add them in no fixed
  order, which moves dq by fp32 rounding only);
- dK and dQ scaled, inverse-rotated in fp32 and rounded to bf16 once, dV
  rounded once;
- at (q.k, v) = (192, 128), the latent-attention instance (no rope),
  the same steps with the scale 1/sqrt(192): the kernel splits dQ's
  columns 96 and 96 between its two consumers, each summing all 128 keys
  of the tile, so each (K tile, Q tile) still adds one partial.

Which products the kernel issues together, and which warp issues dQ's
reduce-adds, move no rounding point, so the emulation does not model
them.

Tolerance against the reference (bf16 inputs): dq, dk, dv
||diff|| / ||ref|| <= 5e-3, chip_smoke.py's kernel bound. Both sides
round P and dS to bf16 before the same products and round each output
once (about 2e-3 relative each); they differ in the exponential (base 2
here) and in summation order, which moves a P or dS value across a bf16
rounding boundary now and then.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_dra.workloads import flashattention as jfa
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

KEYS = 128     # keys per CTA
ROWS = 64      # queries per streamed tile
LOG2E = 1.4426950408889634
B, H = 1, 2
TOL = 5e-3


class TestEntrySignature:
    def test_c_interface(self):
        """q, k, v, dout, lse, delta, dlse, cos, sinm, dq_acc, dq, dk, dv
        pointers; B S H D Dv; q/k's and v's strides; causal, rope,
        element bytes; the stream."""
        args = fk.ARGTYPES["flash_bwd_sm90"]
        assert args[:13] == [_cuda.PTR] * 13
        assert args[13:] == fk._SHAPE + [_cuda.PTR]
        assert args[-2] is _cuda.INT   # element bytes

    def test_pair_signatures_kept(self):
        """The mma route's one fused kernel, which took the dq/dkv pair's
        place, takes this entry's operands: one launch call serves both
        routes."""
        assert fk.ARGTYPES["flash_bwd_mma"] == fk.ARGTYPES["flash_bwd_sm90"]
        assert "flash_bwd_dq" not in fk.ARGTYPES
        assert "flash_bwd_dkv" not in fk.ARGTYPES


def _operands(s, d, seed, dtype=torch.bfloat16, dlse_scale=0.1):
    rs = np.random.RandomState(seed)
    q, k, v, dout = (torch.from_numpy(rs.standard_normal((B, s, H, d))
                                      .astype(np.float32)).to(dtype)
                     for _ in range(4))
    dlse = torch.from_numpy((rs.standard_normal((B, H, s)) * dlse_scale)
                            .astype(np.float32))
    return q, k, v, dout, dlse


class TestCpuPath:
    @pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                         (torch.float32, 16)])
    def test_equals_the_pair_and_launches_nothing(self, dtype, d):
        q, k, v, dout, dlse = _operands(200, d, seed=3, dtype=dtype)
        tables = tfa._rope_operands(200, d, dtype, torch.device("cpu"))
        o, lse = fk.fwd(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta, dlse, tables)
        _cuda.reset_launches()
        dq, dk, dv = fk.bwd(*args, causal=True)
        assert torch.equal(dq, fk.bwd_dq_plain(*args, causal=True))
        want_dk, want_dv = fk.bwd_dkv_plain(*args, causal=True)
        assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
        assert all(n == 0 for n in _cuda.launches().values())

    def test_kernel_launches_names_every_kernel(self):
        """The launch counts are keyed by C entry point: each flash
        kernel's, zero after a reset."""
        _cuda.reset_launches()
        launches = _cuda.launches()
        assert {"flash_fwd_sm90", "flash_fwd", "flash_bwd_sm90",
                "flash_bwd_mma"} <= set(launches)
        assert set(fk.ARGTYPES) <= set(launches)
        assert not any(launches.values())

    def test_autograd_backward_goes_through_bwd(self, monkeypatch):
        """_FlashAttention.backward makes one call to the fused wrapper."""
        calls = []
        real = fk.bwd

        def spy(*args, **kw):
            calls.append(kw["causal"])
            return real(*args, **kw)

        monkeypatch.setattr(fk, "bwd", spy)
        q, k, v = (x.requires_grad_() for x in _operands(64, 32, seed=4,
                                                         dtype=torch.float32)[:3])
        tfa.flash_attention(q, k, v, causal=True, rope=True).sum().backward()
        assert calls == [True]


def _rotate_from_halves(x, cos_half, sinm_half):
    """x [B, S, H, D] rotated as the kernels do: from the tables' first
    halves, x * c + y * s in fp32, rounded to x.dtype."""
    half = x.shape[-1] // 2
    xf = x.float()
    lo, hi = xf[..., :half], xf[..., half:]
    c, s = cos_half[:, None, :].float(), sinm_half[:, None, :].float()
    return torch.cat([lo * c + hi * s, hi * c + lo * (-s)], -1).to(x.dtype)


def emulate_bwd_sm90(q, k, v, dout, lse, delta, dlse, tables, causal):
    """(dq, dk [B, S, H, Dqk], dv [B, S, H, Dv]) bf16: flash_bwd_sm90's
    arithmetic on bf16 q, k [B, S, H, Dqk] and v, dout [B, S, H, Dv]
    inputs, lse/delta/dlse [B, H, S] fp32 (module docstring)."""
    b, s, h, d = q.shape
    if tables is not None:
        cos_half, sinm_half = (t[:, : d // 2] for t in tables)
        q = _rotate_from_halves(q, cos_half, sinm_half)
        k = _rotate_from_halves(k, cos_half, sinm_half)
    n_k, n_q = -(-s // KEYS) * KEYS, -(-s // ROWS) * ROWS

    def heads(x, n):   # [B, S, H, D] -> [B*H, n, D] fp32, zero rows past S
        x = x.float().permute(0, 2, 1, 3).reshape(b * h, s, x.shape[-1])
        return torch.nn.functional.pad(x, (0, 0, 0, n - s))

    def rows(x, n):    # [B, H, S] -> [B*H, n], zero past S
        return torch.nn.functional.pad(x.float().reshape(b * h, s), (0, n - s))

    qh, doh = heads(q, n_q), heads(dout, n_q)
    kh, vh = heads(k, n_k), heads(v, n_k)
    lse2 = rows(lse, n_q) * torch.tensor(LOG2E, dtype=torch.float32)
    corr = rows(dlse, n_q) - rows(delta, n_q)
    sm_scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = sm_scale * torch.tensor(LOG2E, dtype=torch.float32)
    dq_acc = torch.zeros(b * h, n_q, d)
    dk = torch.zeros(b * h, n_k, d)
    dv = torch.zeros(b * h, n_k, v.shape[-1])

    def bf16(x):
        return x.to(torch.bfloat16).float()

    for k0 in range(0, n_k, KEYS):
        keys = k0 + torch.arange(KEYS)
        for q0 in range(k0 if causal else 0, n_q, ROWS):
            qs = q0 + torch.arange(ROWS)
            st = kh[:, keys] @ qh[:, qs].transpose(1, 2)   # [BH, keys, q]
            x = st * scale_log2 - lse2[:, None, qs]
            drop = (keys[:, None] >= s) | (qs[None, :] >= s)
            if causal:
                drop = drop | (qs[None, :] < keys[:, None])
            p = torch.exp2(x.masked_fill(drop, -1e30))
            dpt = vh[:, keys] @ doh[:, qs].transpose(1, 2)
            ds = p * (dpt + corr[:, None, qs])
            dv[:, keys] += bf16(p) @ doh[:, qs]
            dk[:, keys] += bf16(ds) @ qh[:, qs]
            dq_acc[:, qs] += bf16(ds).transpose(1, 2) @ kh[:, keys]

    def finish(acc, scale):   # [B*H, n, D] fp32 -> [B, S, H, D] bf16
        x = acc[:, :s].reshape(b, h, s, acc.shape[-1]).permute(0, 2, 1, 3)
        if scale:
            x = x * sm_scale
            if tables is not None:
                x = fk.rope_rotate(x, *tables, inverse=True)
        return x.to(torch.bfloat16)

    return finish(dq_acc, True), finish(dk, True), finish(dv, False)


def _reference(q, k, v, dout, dlse, causal, rope):
    """The JAX package's bf16 forward and backward rules (interpret
    mode) on the same inputs: (out, lse [B, H, S], dq, dk, dv, tables),
    every array as a torch tensor in the port's layout."""
    s, d = q.shape[1], q.shape[-1]
    blk = s if s <= ROWS else (KEYS if s % KEYS == 0 else ROWS)

    def bh(x):   # [B, S, H, D] -> [B*H, S, D] bf16
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) \
            .transpose(0, 2, 1, 3).reshape(B * H, s, d)

    def back(x):   # [B*H, S, D] -> [B, S, H, D] bf16
        x = torch.from_numpy(np.array(x.astype(jnp.float32)))
        return x.reshape(B, H, s, d).permute(0, 2, 1, 3).to(torch.bfloat16)

    jq, jk, jv, jdo = (bh(x) for x in (q, k, v, dout))
    j_out, j_lse = jfa._fwd_call(jq, jk, jv, causal, blk, blk, True, rope)
    j_dlse = jnp.asarray(dlse.numpy()).reshape(B * H, 1, s)
    grads = jfa._flash_bwd_rule(causal, blk, blk, blk, blk, True, rope,
                                False, (jq, jk, jv, j_out, j_lse),
                                (jdo, j_dlse))
    tables = None
    if rope:   # the reference's own bf16 tables: the same inputs
        (cos_t, sinm_t), _ = jfa._rope_operands(s, d, True,
                                                jnp.dtype("bfloat16"))
        tables = tuple(torch.from_numpy(np.array(t, np.float32))
                       .to(torch.bfloat16) for t in (cos_t, sinm_t))
    lse = torch.from_numpy(np.array(j_lse, np.float32)).reshape(B, H, s)
    return (back(j_out), lse, *(back(g) for g in grads), tables)


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


class TestEmulatedArithmetic:
    @pytest.mark.parametrize("dlse_scale", [0.0, 0.1])
    @pytest.mark.parametrize("rope", [True, False])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("s", [40, 320, 384])
    def test_against_reference(self, s, d, causal, rope, dlse_scale):
        seed = 2000 + s + d + 4 * causal + 2 * rope + (dlse_scale > 0)
        q, k, v, dout, dlse = _operands(s, d, seed, dlse_scale=dlse_scale)
        out, lse, want_dq, want_dk, want_dv, tables = _reference(
            q, k, v, dout, dlse, causal, rope)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        got = emulate_bwd_sm90(q, k, v, dout, lse, delta, dlse, tables,
                               causal)
        for name, g, w in zip(("dq", "dk", "dv"), got,
                              (want_dq, want_dk, want_dv)):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert _rel(g, w) <= TOL, f"{name} {_rel(g, w)}"

    def test_matches_plain_version(self):
        """The emulation and bwd_plain (the kernel's yardstick on the
        card) agree as chip_smoke.py requires of the kernel."""
        q, k, v, dout, dlse = _operands(300, 128, seed=7)
        tables = tfa._rope_operands(300, 128, torch.bfloat16,
                                    torch.device("cpu"))
        o, lse = fk.fwd_plain(q, k, v, tables, causal=True)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta, dlse, tables)
        got = emulate_bwd_sm90(*args, causal=True)
        want = fk.bwd_plain(*args, causal=True)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel(g, w) <= TOL, f"{name} {_rel(g, w)}"

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("s", [40, 320, 384])
    def test_split_head_dims_match_plain_version(self, s, causal):
        """(q.k, v) = (192, 128), MLA's instance (no rope), against
        bwd_plain at ragged (40, 320) and tile-multiple (384) S."""
        rs = np.random.RandomState(3000 + s + causal)

        def randn(*shape):
            return torch.from_numpy(rs.standard_normal(shape)
                                    .astype(np.float32)).to(torch.bfloat16)

        q, k = randn(B, s, H, 192), randn(B, s, H, 192)
        v, dout = randn(B, s, H, 128), randn(B, s, H, 128)
        dlse = torch.from_numpy((rs.standard_normal((B, H, s)) * 0.1)
                                .astype(np.float32))
        o, lse = fk.fwd_plain(q, k, v, None, causal=causal)
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta, dlse, None)
        got = emulate_bwd_sm90(*args, causal=causal)
        want = fk.bwd_plain(*args, causal=causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
            assert _rel(g, w) <= TOL, f"{name} {_rel(g, w)}"
