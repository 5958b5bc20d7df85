"""Port parity at the reference's streaming (XL) tier and the port's
long-context bench, on the CPU.

The reference computes long-context attention with its streaming
kernels (tpu_dra/workloads/flashattention.py:_fwd_stream_kernel,
_bwd_dq_stream_kernel, _bwd_dkv_stream_kernel), engaged past its VMEM
budget or by ``streaming=True``; they run here in interpret mode. The
port has one kernel per direction for both tiers, so the same numpy
inputs go through the port's flash_attention_with_lse, whose wrappers run
the kernels' plain versions on CPU tensors. The loss consumes both
outputs, as the reference's TestStreamingKernels does.

Tolerances:
- fp32 value 1e-4 relative and gradients 1e-4 of max|ref|: the bounds of
  the reference's own streaming-vs-resident test (tests/
  test_flashattention.py:355-358); both sides sum the same fp32 products
  in different orders.
- bf16 out and lse 5e-2 (rtol and atol): the port's bf16 bounds
  (tests/test_torch_flashattention.py:14-16): one bf16 rounding of O on
  each side plus bf16 rounding of P at different points.
"""

import ast
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
from tpu_dra.workloads import flashattention as jfa
from tpu_dra.workloads import model as jm
from tpu_dra_torch import bench as tbench
from tpu_dra_torch.workloads import flashattention as tfa

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

# TestStreamingKernels' shape (tests/test_flashattention.py:327).
B, S, H, D = 2, 384, 2, 16
STREAM = dict(interpret=True, streaming=True, block_q=128, block_k=128)


def _np_inputs(s, seed, d=D):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((B, s, H, d)).astype(np.float32)
            for _ in range(3)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_value_and_grads(xs, dtype, causal, rope):
    def loss(q, k, v):
        out, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                rope=rope, **STREAM)
        return (out.astype(jnp.float32) * 1.7).sum() + (lse * 0.3).sum()

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x).astype(dtype) for x in xs))
    return float(value), [_f32(g) for g in grads]


def _torch_value_and_grads(xs, dtype, causal, rope):
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_() for x in xs)
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            rope=rope)
    value = (out.float() * 1.7).sum() + (lse * 0.3).sum()
    value.backward()
    return float(value.detach()), [_f32(x.grad) for x in (q, k, v)]


def _assert_value_and_grads(got, want):
    (got_v, got_g), (want_v, want_g) = got, want
    assert abs(got_v - want_v) <= 1e-4 * abs(want_v), (got_v, want_v)
    for name, g, w in zip("qkv", got_g, want_g):
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
        assert err <= 1e-4, f"d{name} rel err {err}"


class TestStreamingTierParity:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("rope", [True, False])
    def test_fp32_value_and_grads(self, causal, rope):
        xs = _np_inputs(S, seed=10 + 2 * causal + rope)
        _assert_value_and_grads(
            _torch_value_and_grads(xs, torch.float32, causal, rope),
            _jax_value_and_grads(xs, jnp.float32, causal, rope))

    def test_fp32_ragged_causal(self):
        """S=1000: the reference pads to 1024 and slices back; the port's
        kernels mask the ragged edge themselves."""
        xs = _np_inputs(1000, seed=20)
        _assert_value_and_grads(
            _torch_value_and_grads(xs, torch.float32, True, True),
            _jax_value_and_grads(xs, jnp.float32, True, True))

    def test_bf16_out_and_lse(self):
        xs = _np_inputs(S, seed=30)
        want_o, want_l = jfa.flash_attention_with_lse(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in xs), causal=True,
            rope=True, **STREAM)
        got_o, got_l = tfa.flash_attention_with_lse(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in xs),
            causal=True, rope=True)
        assert got_o.dtype == torch.bfloat16 and got_l.dtype == torch.float32
        np.testing.assert_allclose(_f32(got_o), _f32(want_o), rtol=5e-2,
                                   atol=5e-2)
        np.testing.assert_allclose(_f32(got_l), _f32(want_l), rtol=5e-2,
                                   atol=5e-2)

    def test_reference_streams_where_the_port_has_one_tier(self):
        """The shapes of this slice engage the reference's streaming tier
        (fp32 at S=8192, bf16 at S=16384; D=128 with rope), and the port
        exposes no tier switch."""
        assert jfa._needs_streaming(8192, 128, jnp.float32, True)
        assert jfa._needs_streaming(16384, 128, jnp.bfloat16, True)
        assert not jfa._needs_streaming(8192, 128, jnp.bfloat16, True)
        params = inspect.signature(tfa.flash_attention_with_lse).parameters
        assert "streaming" not in params
        assert not hasattr(tfa, "STREAM_BLOCKS")


def _reference_long_context_config():
    """The keyword arguments of the ModelConfig(...) call inside the
    reference's bench_long_context, read from its source."""
    tree = ast.parse(inspect.getsource(jax_bench.bench_long_context))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "ModelConfig"):
            return {kw.arg: (kw.value.id if isinstance(kw.value, ast.Name)
                             else ast.literal_eval(kw.value))
                    for kw in node.keywords}
    raise AssertionError("no ModelConfig call in bench_long_context")


class TestBenchLongContext:
    @pytest.mark.parametrize("seq", [8192, 16384])
    def test_config_is_the_flagship_at_seq_with_batch_1(self, seq):
        cfg = tbench.long_context_config(seq)
        assert cfg == dataclasses.replace(tbench.FLAGSHIP, max_seq=seq)
        assert tbench.LONG_CONTEXT_BATCH == 1
        want = _reference_long_context_config()
        assert want.pop("max_seq") == "seq"
        for field, value in want.items():
            assert getattr(cfg, field) == value, field
        assert cfg.dtype == torch.bfloat16

    @pytest.mark.parametrize("seq", [8192, 16384])
    def test_flops_per_token_matches_reference(self, seq):
        """At the flagship's width; the parameter count comes from the
        reference's param tree shapes, which nothing allocates."""
        cfg_j = jm.ModelConfig(vocab=32768, d_model=2048, n_heads=16,
                               n_layers=8, d_ff=8192, max_seq=seq)
        shapes = jax.eval_shape(
            lambda: jm.init_params(jax.random.PRNGKey(0), cfg_j))
        n_params = sum(int(np.prod(x.shape))
                       for x in jax.tree.leaves(shapes))
        got = tbench._flops_per_token(tbench.long_context_config(seq),
                                      n_params)
        assert got == jax_bench._flops_per_token(cfg_j, n_params)

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_measures_only_a_card(self, device, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            tbench.bench_long_context(steps=1, seq=64, device=device)
