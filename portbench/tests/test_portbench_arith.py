"""The benchmark's counts against shapes worked by hand: attention's
bounds, the dense and the MoE-active FLOPs, and the per-layer readers on
a trace whose answers are known."""

import pytest

from portbench import frozen, spec
from portbench.models import moe_lm, transformer_lm
from portbench.trace import TraceRun, breakdown

FLAGSHIP = spec.resolve("flagship.s1k_uniform").config
MOE = spec.resolve("moe_lm.s1k_uniform").config
H100 = "NVIDIA H100 80GB HBM3"


def test_bounds_at_the_flagship_shape():
    w = frozen.bounds(8, 1023, 16, 128, 989e12, 3.35e12)
    pairs = 8 * 16 * 1023 * 1024 // 2
    assert pairs == 67_043_328
    assert w["flash_fwd"]["flops"] == 4 * 128 * pairs == 34_326_183_936
    assert w["flash_fwd"]["bytes"] == 4 * 33_521_664 + 523_776 + 523_776
    assert w["flash_fwd"]["bound_by"] == "bytes"
    assert w["flash_fwd"]["bound_ms"] == pytest.approx(0.040338569, rel=1e-6)
    assert w["flash_bwd"]["flops"] == 85_815_459_840
    assert w["flash_bwd"]["bound_by"] == "operations"
    assert w["flash_bwd"]["bound_ms"] == pytest.approx(0.086769928, rel=1e-6)


def test_dense_params_and_flops():
    assert transformer_lm.n_params(FLAGSHIP) == 536_903_680
    flops, matmul = frozen.flops_per_token(32768, 2048, 8, 1024, 536_903_680)
    assert matmul == 469_794_816
    assert flops == 6 * 469_794_816 + 6 * 8 * 1024 * 2048 == 2_919_432_192
    assert transformer_lm.flops_per_token(FLAGSHIP, 1024) == flops


def test_moe_counts_one_expert_per_token():
    assert moe_lm.total_params(MOE) == 1_476_493_312
    # the dense model's params (one FFN a block) plus 4 routers [2048, 8]
    assert moe_lm.active_params(MOE) == 536_903_680 + 4 * 2048 * 8
    assert moe_lm.flops_per_token(MOE, 1024) == \
        6 * (469_794_816 + 4 * 2048 * 8) + 6 * 8 * 1024 * 2048
    # The dense dispatch's all-experts work is no model work.
    assert moe_lm.flops_per_token(MOE, 1024) < \
        1.01 * transformer_lm.flops_per_token(FLAGSHIP, 1024)


def test_attention_calls_per_step():
    assert transformer_lm.attention_calls(FLAGSHIP, 8, 1024) == \
        [(8, 1023, 16, 128)] * 8
    assert moe_lm.attention_calls(MOE, 1, 16384) == [(1, 16383, 16, 128)] * 8


def _run(kernels, **kw):
    fields = dict(host_ops=[], window_s=1.0, steps=2, tokens_per_step=8184,
                  flops_per_token=2_919_432_192.0,
                  attention_calls=[(8, 1023, 16, 128)] * 8,
                  peak_mem_bytes=3 * 2 ** 30, device_name=H100)
    fields.update(kw)
    return TraceRun(kernels=sorted(kernels), **fields)


KERNELS = [
    (0.0, 100_000.0, "nvjet_tst_128x256_h_bz_coopA_NNT"),
    (50_000.0, 150_000.0, "void elementwise_kernel<128, 4>"),
    (200_000.0, 205_000.0, "void flash::flash_fwd_sm90_kernel<128>"),
    (300_000.0, 320_000.0, "void flash::flash_bwd_sm90_kernel<128>"),
    (320_000.0, 321_000.0, "flash_bwd_dq_epilogue"),
]


def read(name, run):
    return spec.metric_reader(name)(run)


def test_readers_on_a_known_trace():
    run = _run(KERNELS)
    # busy: [0, 150] + [200, 205] + [300, 321] ms = 176 ms of 1 s
    assert run.busy_s == pytest.approx(0.176)
    assert read("device.idle_share", run) == pytest.approx(82.4)
    assert read("model.gemm_ms_per_step", run) == pytest.approx(50.0)
    assert read("kernels.attn_ms_per_step", run) == pytest.approx(13.0)
    bound = 8 * (0.040338569 + 0.086769928)
    assert read("kernels.attn_roofline", run) == \
        pytest.approx(100 * bound / 13.0, rel=1e-6)
    assert read("model.mfu", run) == pytest.approx(
        100 * 2_919_432_192 * 8184 * 2 / 1.0 / 989e12)
    assert read("device.peak_mem_gib", run) == pytest.approx(3.0)


def test_readers_find_nothing_to_read():
    empty = _run([], peak_mem_bytes=None, device_name="cpu")
    for m in spec.load_benchmark()["per_layer"]:
        assert read(m["name"], empty) is None
    unknown = _run(KERNELS, device_name="Some Other Card")
    assert read("model.mfu", unknown) is None
    assert read("kernels.attn_roofline", unknown) is None


def test_breakdown_names_gaps_by_host_operation():
    host = [(0.0, 400_000.0, "portbench.step"),
            (160_000.0, 199_000.0, "aten::mm"),
            (204_000.0, 290_000.0, "aten::sub_")]
    b = breakdown(_run(KERNELS, host_ops=host))
    assert b["device_ops"][0] == ["nvjet_tst_128x256_h_bz_coopA_NNT", 0.1]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::sub_ -> void flash::flash_bwd_sm90_kernel<128>"] == \
        pytest.approx(0.095)
    assert gaps["portbench.step -> void flash::flash_fwd_sm90_kernel<128>"] == \
        pytest.approx(0.05)
    assert gaps["window edges: first enqueue, final synchronize"] == \
        pytest.approx(1.0 - 0.321)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
