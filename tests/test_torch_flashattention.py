"""Port parity: tpu_dra_torch.workloads.flashattention (and the kernels'
plain versions in _flash_kernels) against the JAX package's flash
attention, run as the JAX tests run it on the CPU (interpret mode).

The same numpy inputs go to both sides. On the CPU the port's kernel
wrappers run their plain PyTorch versions (a CPU tensor is the only
reason they do); the CUDA kernels themselves are checked against those
plain versions on the card by chip_smoke.py.

Tolerances:
- fp32 out/lse 2e-5 (rtol and atol): the reference's own kernel-vs-
  reference bound for fp32 (tests/test_flashattention.py); the two sides
  sum the same fp32 products in different orders.
- bf16 out/lse 5e-2: one bf16 rounding of O (~4e-3 relative) on each
  side plus bf16 rounding of P at different points (the kernel rounds
  unnormalized tiles, the plain version whole rows).
- fp32 gradients 1e-4 of max|ref|: three chained products in fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_dra.workloads import flashattention as jfa
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

B, H, D = 2, 2, 32


def _np_inputs(s, seed, n=3, shape=None):
    rs = np.random.RandomState(seed)
    shape = shape or (B, s, H, D)
    return [rs.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax(xs, dtype):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_blocks(causal):
    # Non-causal reference needs blocks dividing S (384 = 3 x 128).
    return {} if causal else {"block_q": 128, "block_k": 128}


FWD_CASES = [(s, causal, rope)
             for s in (128, 200, 384)
             for causal in (True, False)
             for rope in (True, False)
             if causal or s != 200]


class TestForwardParity:
    @pytest.mark.parametrize("s,causal,rope", FWD_CASES)
    def test_fp32_out_and_lse(self, s, causal, rope):
        q, k, v = _np_inputs(s, seed=s + 2 * causal + rope)
        want_o, want_l = jfa.flash_attention_with_lse(
            *_jax((q, k, v), jnp.float32), causal=causal, rope=rope,
            interpret=True, **_jax_blocks(causal))
        got_o, got_l = tfa.flash_attention_with_lse(
            *_torch((q, k, v), torch.float32), causal=causal, rope=rope)
        assert got_o.shape == (B, s, H, D) and got_l.shape == (B, H, s)
        assert got_l.dtype == torch.float32
        np.testing.assert_allclose(_f32(got_o), _f32(want_o),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_f32(got_l), _f32(want_l),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("s,causal,rope",
                             [(200, True, True), (384, False, True),
                              (128, True, False)])
    def test_bf16_out_and_lse(self, s, causal, rope):
        q, k, v = _np_inputs(s, seed=40 + s)
        want_o, want_l = jfa.flash_attention_with_lse(
            *_jax((q, k, v), jnp.bfloat16), causal=causal, rope=rope,
            interpret=True, **_jax_blocks(causal))
        got_o, got_l = tfa.flash_attention_with_lse(
            *_torch((q, k, v), torch.bfloat16), causal=causal, rope=rope)
        assert got_o.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got_o), _f32(want_o),
                                   rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(_f32(got_l), _f32(want_l),
                                   rtol=5e-2, atol=5e-2)

    def test_noncausal_indivisible_refused_like_reference(self):
        q, k, v = _np_inputs(200, seed=1)
        with pytest.raises(ValueError, match="not divisible"):
            jfa.flash_attention(*_jax((q, k, v), jnp.float32), causal=False,
                                block_q=128, block_k=128)
        with pytest.raises(ValueError, match="not divisible"):
            tfa.flash_attention(*_torch((q, k, v), torch.float32),
                                causal=False)

    def test_noncausal_single_ragged_tile_is_exact(self):
        """S under one kernel tile: the key mask drops the ragged edge."""
        q, k, v = _np_inputs(40, seed=2)
        want = jfa.flash_attention(*_jax((q, k, v), jnp.float32),
                                   causal=False, interpret=True)
        got = tfa.flash_attention(*_torch((q, k, v), torch.float32),
                                  causal=False)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-5)


def _joint_loss_jax(causal, rope, use_lse):
    def loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(
            q, k, v, causal=causal, rope=rope, interpret=True,
            **_jax_blocks(causal))
        total = jnp.sum(out * jnp.sin(out))
        return total + jnp.sum(lse * lse) if use_lse else total
    return loss


def _joint_loss_torch(causal, rope, use_lse):
    def loss(q, k, v):
        out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                rope=rope)
        total = (out * torch.sin(out)).sum()
        return total + (lse * lse).sum() if use_lse else total
    return loss


class TestJointGradients:
    """The autograd Function over (out, lse): dlse flows into dS, and an
    out-only consumer (dlse None) degenerates to plain flash."""

    @pytest.mark.parametrize("s,causal,rope,use_lse", [
        (200, True, True, True),     # padded causal edge + fused rope
        (256, True, False, True),
        (384, False, True, True),
        (200, True, True, False),    # dlse is None
    ])
    def test_fp32_grads(self, s, causal, rope, use_lse):
        q, k, v = _np_inputs(s, seed=60 + s + use_lse)
        want = jax.grad(_joint_loss_jax(causal, rope, use_lse),
                        argnums=(0, 1, 2))(*_jax((q, k, v), jnp.float32))
        tq, tk, tv = (x.requires_grad_() for x in _torch((q, k, v),
                                                          torch.float32))
        _joint_loss_torch(causal, rope, use_lse)(tq, tk, tv).backward()
        for name, w, g in zip("qkv", want, (tq.grad, tk.grad, tv.grad)):
            w = _f32(w)
            err = np.abs(_f32(g) - w).max() / np.abs(w).max()
            assert err <= 1e-4, f"d{name} rel err {err}"


class TestKernelPlainVersions:
    """_flash_kernels' plain versions against the Pallas kernels they
    stand for, called at the [BH, S, D] primitive level with a nonzero
    dlse cotangent (the term the model's own path leaves at zero)."""

    @pytest.mark.parametrize("causal,rope", [(True, True), (False, True),
                                             (True, False)])
    def test_fwd_dq_dkv(self, causal, rope):
        s, blk = 256, 128
        q, k, v, dout = _np_inputs(s, seed=80 + 2 * causal + rope, n=4)
        dlse, = _np_inputs(s, seed=90, n=1, shape=(B, H, s))

        def bh(x):   # [B, S, H, D] -> [B*H, S, D]
            return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, s, D)

        jq, jk, jv, jdo = (bh(x) for x in (q, k, v, dout))
        j_out, j_lse = jfa._fwd_call(jq, jk, jv, causal, blk, blk, True, rope)
        j_dlse = jnp.asarray(dlse).reshape(B * H, 1, s)
        j_dq, j_dk, j_dv = jfa._flash_bwd_rule(
            causal, blk, blk, blk, blk, True, rope, False,
            (jq, jk, jv, j_out, j_lse), (jdo, j_dlse))

        tq, tk, tv, tdo = _torch((q, k, v, dout), torch.float32)
        tables = (tfa._rope_operands(s, D, torch.float32, torch.device("cpu"))
                  if rope else None)
        o, lse = fk.fwd(tq, tk, tv, tables, causal=causal)
        delta = (tdo * o).sum(-1).transpose(1, 2)
        args = (tq, tk, tv, tdo, lse, delta, torch.from_numpy(dlse), tables)
        dq = fk.bwd_dq(*args, causal=causal)
        dk, dv = fk.bwd_dkv(*args, causal=causal)

        def to_bh(x):
            return _f32(x).transpose(0, 2, 1, 3).reshape(B * H, s, D)

        np.testing.assert_allclose(to_bh(o), _f32(j_out), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(_f32(lse).reshape(B * H, s),
                                   _f32(j_lse)[:, 0], rtol=2e-5, atol=2e-5)
        for name, got, want in (("dq", dq, j_dq), ("dk", dk, j_dk),
                                ("dv", dv, j_dv)):
            want = _f32(want)
            err = np.abs(to_bh(got) - want).max() / np.abs(want).max()
            assert err <= 1e-4, f"{name} rel err {err}"

    def test_cpu_path_launches_nothing(self):
        fk.reset_launches()
        q, k, v = _torch(_np_inputs(64, seed=3), torch.float32)
        fk.fwd(q, k, v, None, causal=True)
        assert fk.launches() == {"flash_fwd": 0, "flash_bwd": 0,
                                 "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


class TestRope:
    def test_rope_half_matches_reference(self):
        x, = _np_inputs(48, seed=5, n=1)
        pos = np.arange(48)[None, :]
        want = jfa.rope_half(jnp.asarray(x), jnp.asarray(pos))
        got = tfa.rope_half(torch.from_numpy(x), torch.from_numpy(pos))
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=1e-6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_tables_match_reference_operands(self, dtype):
        """bf16 inputs get bf16 tables, as _rope_operands stores them."""
        (j_cos, j_sinm), _ = jfa._rope_operands(200, 64, True,
                                                jnp.dtype(dtype))
        t_cos, t_sinm = tfa._rope_operands(200, 64, getattr(torch, dtype),
                                           torch.device("cpu"))
        assert t_cos.dtype == getattr(torch, dtype)
        # One bf16 ulp (2^-8) at most: fp32 trig may differ in the last
        # bit between the two libraries before rounding.
        tol = 1e-6 if dtype == "float32" else 2 ** -8
        np.testing.assert_allclose(_f32(t_cos), _f32(j_cos), atol=tol)
        np.testing.assert_allclose(_f32(t_sinm), _f32(j_sinm), atol=tol)


class TestAttendDispatch:
    @pytest.mark.parametrize("impl_jax,impl_torch", [
        ("auto", "auto"),                 # CPU: plain reference on both
        ("reference", "reference"),
        ("flash_interpret", "flash"),     # kernel path: plain versions
    ])
    def test_paths_agree_with_reference(self, impl_jax, impl_torch):
        q, k, v = _np_inputs(256, seed=7)
        want = jfa.attend(*_jax((q, k, v), jnp.float32), causal=True,
                          impl=impl_jax, platform="cpu", rope=True)
        got = tfa.attend(*_torch((q, k, v), torch.float32), causal=True,
                         impl=impl_torch, rope=True)
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-5)

    @pytest.mark.parametrize("causal,match", [
        (False, "not divisible"),   # the refusal, not the plain reference
        (True, "no flash kernel"),  # the kernel wrapper, not the reference
    ])
    def test_auto_off_cpu_takes_flash_path(self, causal, match):
        """Off the CPU, "auto" is the flash path: a non-causal S the
        kernels refuse raises instead of running the plain reference.
        Meta tensors stand in for the card here."""
        q = torch.zeros(1, 200, 1, 64, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match=match):
            tfa.attend(q, q, q, causal=causal, impl="auto", rope=True)

    def test_unknown_impl(self):
        q, k, v = _torch(_np_inputs(16, seed=8), torch.float32)
        with pytest.raises(ValueError, match="unknown attention impl"):
            tfa.attend(q, k, v, impl="pallas")


class TestKernelInputChecks:
    """What the CUDA wrappers refuse, checked on CPU tensors of the same
    shapes (the checks run before any launch)."""

    def test_fp32_inputs_pass_with_fp32_tables_kept(self):
        q = torch.zeros(1, 64, 1, 128)
        tables = tfa._rope_operands(64, 128, torch.float32,
                                    torch.device("cpu"))
        got_q, _, _, got_tables = fk._kernel_inputs(q, q, q, tables)
        assert got_q.dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in got_tables)
        # fp32 tables are the fp32 tables, unrounded.
        for got, want in zip(got_tables, tables):
            assert torch.equal(got, want)

    def test_bf16_inputs_get_bf16_tables(self):
        q = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16)
        fp32_tables = tfa._rope_operands(64, 64, torch.float32,
                                         torch.device("cpu"))
        _, _, _, got = fk._kernel_inputs(q, q, q, fp32_tables)
        assert all(t.dtype == torch.bfloat16 for t in got)
        for got_t, want in zip(got, fp32_tables):
            assert torch.equal(got_t, want.to(torch.bfloat16))

    @pytest.mark.parametrize("dtypes", [
        (torch.float16,) * 3,                                 # float16
        (torch.float32, torch.bfloat16, torch.bfloat16),      # mixed
        (torch.bfloat16, torch.bfloat16, torch.float32),
    ])
    def test_float16_and_mixed_types_refused(self, dtypes):
        q, k, v = (torch.zeros(1, 64, 1, 64, dtype=dt) for dt in dtypes)
        with pytest.raises(TypeError, match="float32|differ"):
            fk._kernel_inputs(q, k, v, None)

    def test_each_kernel_is_told_the_element_size(self):
        """The C entry points take the element size after the shape."""
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert fk.ARGTYPES[name][-2] is fk._INT
        for dtype, size in fk.KERNEL_DTYPES.items():
            q = torch.zeros(1, 64, 2, 32, dtype=dtype)
            assert fk._dims(q, True, None)[-1] == size == q.element_size()

    @pytest.mark.parametrize("d", [24, 144])
    def test_head_dim_refused(self, d):
        q = torch.zeros(1, 64, 1, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            fk._kernel_inputs(q, q, q, None)

    @pytest.mark.parametrize("d", [32, 64, 96])
    def test_fp32_head_dim_without_instance_refused(self, d):
        """bf16 takes every multiple of 16; fp32 only the dims it is
        built for, refused before a launch could return an error."""
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 64, 1, d, dtype=dtype)
            if dtype == torch.bfloat16:
                fk._kernel_inputs(q, q, q, None)
                continue
            with pytest.raises(ValueError, match="fp32 kernels are built"):
                fk._kernel_inputs(q, q, q, None)

    @pytest.mark.parametrize("d", fk.FP32_HEAD_DIMS)
    def test_fp32_head_dims_with_instance_pass(self, d):
        q = torch.zeros(1, 64, 1, d)
        assert fk._kernel_inputs(q, q, q, None)[0].dtype == torch.float32

    def test_fused_projection_views_pass_in_place(self):
        qkv = torch.zeros(2, 64, 3 * 128, dtype=torch.bfloat16)
        q, k, v = (t.view(2, 64, 2, 64) for t in qkv.split(128, dim=-1))
        got = fk._kernel_inputs(q, k, v, None)
        assert all(a is b for a, b in zip(got[:3], (q, k, v)))

    def test_other_device_refused(self):
        q = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="no flash kernel"):
            fk.fwd(q, q, q, None, causal=True)
