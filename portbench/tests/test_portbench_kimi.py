"""The Kimi Linear cell's counts and readers: the family's parameters and
FLOPs against its configuration, the KDA calls beside the MLA calls, the
KDA kernels' bound by hand, the new readers (``kernels.kda_roofline``,
``attention.kda_ms_per_step``) on traces whose answers are known, the
MLA roofline reading only the attention kernels beside the KDA kernels,
and ``kda_ranges`` linking the KDA layer's backward on synthetic events
and on a CPU profile of a tiny step."""

import pytest
import torch

from portbench import frozen, kda_ranges, ranges, spec
from portbench.models import kimi_lm
from portbench.models.dsv3_lm import mla_attention_bounds
from portbench.reference import kimi_lm as reference
from portbench.tests.test_portbench_spans import (
    FIELDS, _events, _ev, _profiled, read)
from portbench.trace import TraceRun, from_profile

CELL = "kimi_linear.s32k_uniform"
KIMI = spec.resolve(CELL).config
MLA_CALL = (1, 32767, 32, 192, 128)
KDA_CALL = (1, 32767, 32, 128, 128)


def test_params_and_flops_match_the_configuration():
    assert kimi_lm.total_params(KIMI) == KIMI["n_params"] == 903_489_472
    # Per token: 6 KDA layers' projections (q, k, v, the low-rank decay
    # and gate, beta, o), 2 MLA layers', the dense FFN, 7 MoE layers'
    # router, shared expert and 0.25 of one routed expert, the
    # unembedding.
    d, hk = 2304, 32 * 128
    kda = 3 * d * hk + 2 * (d * 128 + 128 * hk) + d * 32 + hk * d
    mla = d * 32 * 192 + d * 576 + 512 * 32 * 256 + 32 * 128 * d
    moe = d * 256 + 3 * d * 1024 + 0.25 * 3 * d * 1024
    active = 6 * kda + 2 * mla + 3 * d * 9216 + 7 * moe + d * 20480
    assert kimi_lm.active_matmul_params(KIMI) == active == 471_941_120
    chunk = (2 * 64 * 128 + 64 * 256 + 6 * 128 * 128 + 64 * 128)
    assert kimi_lm.kda_flops_per_token(128, 128) == chunk == 139_264
    assert kimi_lm.flops_per_token(KIMI, 32768) == (
        6 * active + 3 * 2 * 32768 * 32 * 320 + 3 * 6 * 32 * chunk)


def test_layer_kinds_and_calls():
    kinds = [reference.is_kda_block(KIMI, i) for i in range(8)]
    assert kinds == [True, True, True, False, True, True, True, False]
    calls = kimi_lm.attention_calls(KIMI, 1, 32768)
    assert list(calls) == [MLA_CALL] * 2
    assert calls.kda == [KDA_CALL] * 6
    cfg = kimi_lm.model_config(KIMI, 32768)
    assert cfg.kda_pattern == tuple(int(k) for k in kinds)
    assert (cfg.kda_heads, cfg.kda_head_dim, cfg.kda_rank) == (32, 128, 128)
    assert cfg.mla_use_nope and cfg.n_shared == 1 and cfg.top_k == 8
    assert cfg.experts_held == (0, 8) and cfg.n_routed == 256
    assert cfg.dtype == torch.bfloat16


def test_kda_bounds_by_hand():
    work = kimi_lm.kda_bounds(*KDA_CALL, 989e12, 3.35e12)
    n = 32767 * 32
    fwd = n * (4 * 128 * 2 + 128 * 4 + 4)       # q, k, v, o; g; beta
    # q, k, v, dO, g, beta in; dq, dk, dv, dg, dbeta out.
    bwd = n * (7 * 128 * 2 + 2 * 128 * 4 + 2 * 4)
    assert work["kda_fwd"]["bytes"] == fwd       # ~1.61 GB
    assert work["kda_bwd"]["bytes"] == bwd       # ~2.96 GB
    assert 1.6e9 < fwd < 1.62e9 and 2.95e9 < bwd < 2.97e9
    assert work["kda_fwd"]["bound_by"] == work["kda_bwd"]["bound_by"] \
        == "bytes"
    assert work["kda_bwd"]["flops"] == 2 * work["kda_fwd"]["flops"] \
        == 2 * n * 139_264
    total = 6 * (work["kda_fwd"]["bound_ms"] + work["kda_bwd"]["bound_ms"])
    assert 8.0 < total < 8.4                     # ~8.2 ms a step


def _run(kernels, calls=None, steps=2):
    calls = calls if calls is not None else kimi_lm.attention_calls(
        KIMI, 1, 32768)
    return TraceRun(kernels=kernels, host_ops=[],
                    **dict(FIELDS, steps=steps, tokens_per_step=32767,
                           attention_calls=calls))


def test_kda_roofline_reader():
    kernels = [(0.0, 300_000.0, "kda_intra_bwd_kernel(__nv_bfloat16 const*)"),
               (300_000.0, 500_000.0, "kda_state_fwd_kernel(float const*)"),
               (500_000.0, 800_000.0, "flash_fwd_sm90_kernel"),
               (800_000.0, 900_000.0, "nvjet_gemm")]
    run = _run(kernels)
    ranges.remember(run, None, {"attention.kda_tokens": 2 * 6 * 32767,
                                "attention.kda_chunks": 2 * 6 * 32 * 512})
    work = kimi_lm.kda_bounds(*KDA_CALL, 989e12, 3.35e12)
    bound = 6 * (work["kda_fwd"]["bound_ms"] + work["kda_bwd"]["bound_ms"])
    # 500 ms of kda_ kernels over 2 steps: 250 ms a step.
    assert read("kernels.kda_roofline", run) == pytest.approx(
        100 * bound / 250.0)
    # Half the calls counted (a step with 3 KDA layers), half the bound.
    half = _run(kernels)
    ranges.remember(half, None, {"attention.kda_tokens": 2 * 3 * 32767})
    assert read("kernels.kda_roofline", half) == pytest.approx(
        50 * bound / 250.0)
    # No counter, no kda_ kernel, or no KDA calls: None.
    bare = _run(kernels)
    ranges.remember(bare, None, {})
    assert read("kernels.kda_roofline", bare) is None
    other = _run(kernels[2:])
    ranges.remember(other, None, {"attention.kda_tokens": 2 * 6 * 32767})
    assert read("kernels.kda_roofline", other) is None
    plain = _run(kernels, calls=[MLA_CALL] * 2)
    ranges.remember(plain, None, {"attention.kda_tokens": 2 * 6 * 32767})
    assert read("kernels.kda_roofline", plain) is None


def test_mla_roofline_reads_only_the_attention_kernels():
    """The KDA kernels are not attention kernels by frozen.category:
    kernels.mla_attn_roofline reads the MLA calls over the flash_ kernels
    alone, as in Moonlight's cell."""
    kernels = [(0.0, 100_000.0, "flash_fwd_sm90_kernel"),
               (100_000.0, 900_000.0, "kda_intra_bwd_kernel(float const*)")]
    assert frozen.category(kernels[1][2]) != frozen.ATTENTION
    run = _run(kernels, steps=1)
    work = mla_attention_bounds(*MLA_CALL, 989e12, 3.35e12)
    bound = 2 * (work["flash_fwd"]["bound_ms"] + work["flash_bwd"]["bound_ms"])
    # 100 ms of flash_ kernels a step.
    assert read("kernels.mla_attn_roofline", run) == pytest.approx(bound)


# The base trace with attention.kda where moe.route was: one more forward
# op inside it on thread 1 (the chunk op), and its backward node on
# thread 2 whose sequence number is its.
def _kda_events():
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in _events(True) if e.name != "moe.route"]
    ev += [
        _ev("attention.kda", 40, 50),
        _ev("_KDAChunk", 41, 49, id=21, seq=31),
        _ev("cudaLaunchKernel", 42, 43, id=201, linked=21),
        _ev("kda_state_fwd_kernel", 1310, 1330, device=cuda, thread=7,
            id=201),
        _ev(ranges.BACKWARD_NODE + ": _KDAChunkBackward", 172, 176,
            thread=2, seq=31, fwd_thread=1),
        _ev("cudaLaunchKernel", 173, 174, thread=2, id=203, linked=23),
        _ev("kda_intra_bwd_kernel", 1510, 1590, device=cuda, thread=7,
            id=203),
    ]
    return ev


def test_kda_ranges_link_the_layers_backward():
    program = kda_ranges.from_events(_kda_events(), 1)
    assert (kda_ranges.KDA, "_KDAChunkBackward") in {
        (name, node) for _, _, _, name, node in program.links}
    # attention.kda [40, 50) also holds the base trace's aten::mm (its
    # kernel 100 us, its MmBackward0's 100 us).
    assert program.range_ms_per_step(kda_ranges.KDA) == \
        pytest.approx((100 + 20 + 100 + 80) / 1e3)
    # A trace without the range has no KDA view.
    assert kda_ranges.from_events(_events(True), 1) is None


def test_kda_ms_reader_on_a_synthetic_session(monkeypatch):
    run = _run([], steps=1)
    monkeypatch.setattr(kda_ranges, "_SEEN", {})
    monkeypatch.setattr(ranges, "session_events",
                        lambda r: _kda_events() if r is run else None)
    assert read("attention.kda_ms_per_step", run) == pytest.approx(0.3)
    other = _run([], steps=1)
    assert read("attention.kda_ms_per_step", other) is None


def test_cpu_profile_links_the_kda_backward():
    from tpu_dra_torch.infra.trace import read_counters
    from tpu_dra_torch.workloads import kimi_model as km

    g = torch.Generator().manual_seed(0)
    cfg = km.KimiConfig(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=48,
                        max_seq=16, dtype=torch.float32, attn_impl="flash",
                        qk_nope_dim=8, qk_rope_dim=8, v_head_dim=8,
                        kv_rank=16, moe_d_ff=16, n_routed=8,
                        experts_held=(0, 4), top_k=2, kda_pattern=(1, 0),
                        kda_heads=2, kda_head_dim=8, kda_rank=8)
    step = km.make_train_step(km.KimiLM(cfg, km.init_params(cfg, g, "cpu")),
                              lr=1e-2)
    tokens = torch.randint(0, 64, (2, 17), generator=g)
    step(tokens)
    prof = _profiled(lambda: step(tokens))
    run = from_profile(prof.events(), **dict(FIELDS, device_name="cpu"))
    program = kda_ranges.of(run)
    linked = {(name, node) for _, _, _, name, node in program.links}
    assert (kda_ranges.KDA, "_KDAChunkBackward") in linked
    assert (kda_ranges.KDA, "_ShortConvBackward") in linked
    assert (kda_ranges.KDA, "_GatedNormBackward") in linked
    assert kda_ranges.of(run) is program        # read once per run
    counts = ranges.counters(run)
    assert counts["attention.kda_tokens"] == 2 * 16
    assert counts["attention.kda_chunks"] == 2 * 2 * 1
    assert read_counters() == {}
