"""The Moonlight cell's counts and readers: the family's parameters and
FLOPs against its configuration, the split-head-dim attention bound
against ``frozen.bounds``, the new per-layer readers on traces whose
answers are known, and ``named_ranges`` linking backward nodes to the
family's own ranges (``mla.project``, ``moe.shared``), on synthetic
events and on a CPU profile of a tiny step."""

import pytest
import torch

from portbench import frozen, named_ranges, ranges, spec
from portbench.models import dsv3_lm
from portbench.tests.test_portbench_spans import (
    FIELDS, _events, _ev, _profiled, read)
from portbench.trace import TraceRun, from_profile

CELL = "moonlight.s8k_uniform"
MOONLIGHT = spec.resolve(CELL).config


def test_params_and_flops_match_the_configuration():
    assert dsv3_lm.total_params(MOONLIGHT) == MOONLIGHT["n_params"] \
        == 869_702_080
    # Per token: 8 layers of attention projections, the dense FFN, 7 MoE
    # layers' router, shared expert and 0.75 of one routed expert, the
    # unembedding.
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 2048 * 2048
    moe = 2048 * 64 + 3 * 2048 * 2816 + 0.75 * 3 * 2048 * 1408
    active = 8 * attn + 3 * 2048 * 11264 + 7 * moe + 2048 * 20480
    assert dsv3_lm.active_matmul_params(MOONLIGHT) == active == 388_694_016
    assert dsv3_lm.flops_per_token(MOONLIGHT, 8192) == \
        6 * active + 3 * 8 * 8192 * 16 * (192 + 128) == 3_338_797_056


def test_attention_calls_carry_both_head_dims():
    assert dsv3_lm.attention_calls(MOONLIGHT, 6, 8192) == \
        [(6, 8191, 16, 192, 128)] * 8


@pytest.mark.parametrize("shape", [(8, 1023, 16), (1, 16384, 16)])
def test_split_bound_at_equal_dims_is_frozen_bounds(shape):
    split = dsv3_lm.mla_attention_bounds(*shape, 128, 128, 989e12, 3.35e12)
    frozen_ = frozen.bounds(*shape, 128, 989e12, 3.35e12)
    for name in ("flash_fwd", "flash_bwd"):
        assert split[name]["flops"] == frozen_[name]["flops"]
        # frozen.bounds also counts the rope tables, which MLA's kernels
        # do not read.
        assert frozen_[name]["bytes"] - split[name]["bytes"] == \
            2 * shape[1] * 128 * 2


def test_mla_roofline_reader():
    run = TraceRun(kernels=[(0.0, 200_000.0, "flash_fwd_sm90_kernel")],
                   host_ops=[], **dict(FIELDS, attention_calls=[
                       (6, 8191, 16, 192, 128)] * 8))
    bound = dsv3_lm.mla_attention_bounds(6, 8191, 16, 192, 128, 989e12,
                                         3.35e12)
    want = 8 * (bound["flash_fwd"]["bound_ms"]
                + bound["flash_bwd"]["bound_ms"]) / 200.0 * 100
    assert read("kernels.mla_attn_roofline", run) == pytest.approx(want)
    assert 25 < want < 35     # 60 ms of bound over 200 ms of kernels
    four = TraceRun(kernels=run.kernels, host_ops=[], **FIELDS)
    assert read("kernels.mla_attn_roofline", four) is None


def test_moe_readers_on_known_counts():
    tokens = 6 * 8191
    counts = {"moe.routed": 7 * tokens, "moe.assigned": 7 * 36_000.0,
              "moe.load_max": 7 * 5_000.0, "moe.tokens_held": 7 * 28_000.0,
              "moe.held": 7 * 8,
              "moe.selected": 7 * 6 * tokens, "moe.row_bytes": 7 * 4096}
    kernels = [(0.0, 100.0, "void moe::route_topk_kernel(int const*)"),
               (100.0, 400.0, "void moe::gather_rows_kernel<bf16>()"),
               (400.0, 700.0, "void moe::combine_rows_kernel<bf16>()"),
               (700.0, 800.0, "void moe::row_dot_kernel<bf16, true>()"),
               (800.0, 5000.0, "nvjet_gemm")]
    run = TraceRun(kernels=kernels, host_ops=[],
                   **dict(FIELDS, tokens_per_step=tokens))
    ranges.remember(run, None, counts)
    assert read("moe.load_imbalance", run) == pytest.approx(5000 / 4500)
    nbytes = 7 * dsv3_lm.moe_kernel_bytes(tokens, 6 * tokens, 36_000.0,
                                          28_000.0, 4096)
    assert read("kernels.moe_route_roofline", run) == pytest.approx(
        100 * nbytes / 3.35e12 * 1e6 / 800.0)
    none = TraceRun(kernels=kernels, host_ops=[], **FIELDS)
    ranges.remember(none, None, {})
    assert read("moe.load_imbalance", none) is None
    assert read("kernels.moe_route_roofline", none) is None
    # A port that counts held pairs but not the widths (this family's
    # first form) reads None, not a guess.
    bare = TraceRun(kernels=kernels, host_ops=[],
                    **dict(FIELDS, tokens_per_step=tokens))
    ranges.remember(bare, None, {k: counts[k] for k in (
        "moe.routed", "moe.assigned", "moe.load_max")})
    assert read("moe.load_imbalance", bare) is None
    assert read("kernels.moe_route_roofline", bare) is None


def test_moe_kernel_bytes_by_hand():
    # t 10 tokens, 20 pairs (k 2), n 8 held pairs of u 6 tokens, 8-byte
    # rows (d 4, bf16).
    assert dsv3_lm.moe_kernel_bytes(10, 20, 8, 6, 8) == (
        (80 + 4 * (20 + 16))              # route
        + (48 + 32 + 64)                  # dispatch
        + (64 + 160 + 80)                 # combine
        + (64 + 80 + 80)                  # dispatch's backward
        + (48 + 64 + 64 + 48 + 64 + 160))  # combine's backward


# The base trace with mla.project where moe.route was and moe.shared
# after it: one more forward op inside each on thread 1, and backward
# nodes on thread 2 whose sequence numbers are theirs.
def _family_events():
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in _events(True) if e.name != "moe.route"]
    ev += [
        _ev("mla.project", 40, 50), _ev("moe.shared", 52, 60),
        _ev("aten::mm", 41, 44, id=21, seq=31),
        _ev("cudaLaunchKernel", 42, 43, id=201, linked=21),
        _ev("nvjet_q_proj", 1310, 1330, device=cuda, thread=7, id=201),
        _ev("aten::mm", 53, 56, id=22, seq=32),
        _ev("cudaLaunchKernel", 54, 55, id=202, linked=22),
        _ev("nvjet_shared", 1330, 1370, device=cuda, thread=7, id=202),
        _ev(ranges.BACKWARD_NODE + ": MmBackward0", 172, 176, thread=2,
            seq=31, fwd_thread=1),
        _ev("cudaLaunchKernel", 173, 174, thread=2, id=203, linked=23),
        _ev("nvjet_q_proj_bwd", 1510, 1590, device=cuda, thread=7, id=203),
        _ev(ranges.BACKWARD_NODE + ": MmBackward0", 180, 186, thread=2,
            seq=32, fwd_thread=1),
        _ev("cudaLaunchKernel", 181, 182, thread=2, id=204, linked=24),
        _ev("nvjet_shared_bwd", 1590, 1595, device=cuda, thread=7, id=204),
    ]
    return ev


def test_named_ranges_link_the_familys_backward():
    program = named_ranges.from_events(_family_events(), 1)
    assert {(name, node) for _, _, _, name, node in program.links} >= {
        ("mla.project", "MmBackward0"), ("moe.shared", "MmBackward0")}
    # mla.project [40, 50) also holds the base trace's aten::mm (its
    # kernel 100 us, its MmBackward0's 100 us).
    assert program.range_ms_per_step("mla.project") == \
        pytest.approx((100 + 20 + 100 + 80) / 1e3)
    assert program.range_ms_per_step("moe.shared") == \
        pytest.approx((40 + 5) / 1e3)
    # ranges.py's fixed names read neither range.
    assert ranges.from_events(_family_events(), 1).range_ms_per_step(
        "mla.project") is None
    # A trace without the family's ranges has no named view.
    assert named_ranges.from_events(_events(True), 1) is None


def test_cpu_profile_links_mla_and_shared_backward():
    from tpu_dra_torch.infra.trace import read_counters
    from tpu_dra_torch.workloads import dsv3_model as dm

    g = torch.Generator().manual_seed(0)
    cfg = dm.DSV3Config(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=48,
                        max_seq=16, dtype=torch.float32, attn_impl="flash",
                        moe_d_ff=16, n_routed=8, experts_held=(0, 4),
                        top_k=2)
    step = dm.make_train_step(dm.DSV3LM(cfg, dm.init_params(cfg, g, "cpu")),
                              lr=1e-2)
    tokens = torch.randint(0, 64, (2, 17), generator=g)
    step(tokens)
    prof = _profiled(lambda: step(tokens))
    run = from_profile(prof.events(), **dict(FIELDS, device_name="cpu"))
    program = named_ranges.of(run)
    linked = {(name, node) for _, _, _, name, node in program.links}
    assert ("mla.project", "MmBackward0") in linked
    assert ("moe.shared", "MmBackward0") in linked
    assert ("moe.experts", "SiluBackward0") in linked
    assert named_ranges.of(run) is program      # read once per run
    counts = ranges.counters(run)
    assert counts["moe.routed"] == 2 * 16 and counts["moe.assigned"] > 0
    # One route call: 4 experts held, k 2, fp32 rows of 32.
    assert (counts["moe.held"], counts["moe.selected"],
            counts["moe.row_bytes"]) == (4, 2 * 16 * 2, 32 * 4)
    assert read_counters() == {}
