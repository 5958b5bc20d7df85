"""Port parity: tpu_dra_torch.workloads.allreduce (the all-reduce probe
and the one-device memory-bandwidth proxy), meshbuild's "allreduce"
workload and bench.bench_psum, against the reference's records.

The collective runs on two spawned gloo ranks (one RankPool for the
module); the reference's records come from its own functions on its
8-device CPU mesh. Times on the CPU are host-clock readings of gloo, so
the tests hold the records' keys, the bus factor 2(n-1)/n, the exact
zeros of one device, and that a chained, 1/n-prescaled all-reduce keeps
its values at 1.0 (exactly: 1/2 and sums of halves are exact in bf16).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_dra_torch import bench as tbench
from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import allreduce as tar

torch.set_num_threads(2)

WORLD = 2
RECORD_KEYS = {"algo_gbps", "bus_gbps", "n_devices", "payload_mib", "mean_s"}


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _bw_task(nbytes):
    return tar.allreduce_bandwidth(nbytes_per_device=nbytes, iters=2,
                                   warmup=1)


def test_record_matches_reference_keys(pool):
    import jax

    from tpu_dra.workloads.allreduce import allreduce_bandwidth

    want = allreduce_bandwidth(nbytes_per_device=1 << 16, iters=1, warmup=1,
                               devices=jax.devices()[:WORLD])
    for got in pool.run(_bw_task, 1 << 16):
        assert set(got) == set(want) == RECORD_KEYS
        assert got["n_devices"] == want["n_devices"] == 2.0
        assert got["payload_mib"] == want["payload_mib"]
        assert got["algo_gbps"] > 0 and got["mean_s"] > 0
        assert got["bus_gbps"] == pytest.approx(
            got["algo_gbps"] * 2 * (WORLD - 1) / WORLD)


def test_one_device_reads_exact_zeros():
    """No group: one device, no collective to time (the reference's
    single-device record, value for value)."""
    import jax

    from tpu_dra.workloads.allreduce import allreduce_bandwidth

    want = allreduce_bandwidth(nbytes_per_device=1 << 16, iters=1, warmup=1,
                               devices=jax.devices()[:1])
    got = tar.allreduce_bandwidth(nbytes_per_device=1 << 16, iters=1,
                                  warmup=1)
    assert got == want
    assert got["algo_gbps"] == 0.0 and got["bus_gbps"] == 0.0


def _chain_task(k):
    x = torch.ones(8, dtype=torch.bfloat16)
    for _ in range(k):
        x.mul_(1.0 / WORLD)
        dist.all_reduce(x)
    return x.float().numpy()


def test_prescaled_chain_keeps_its_values(pool):
    """Each all-reduce consumes the last one's output, prescaled by 1/n,
    so the values stay at 1.0 however long the chain."""
    for got in pool.run(_chain_task, 25):
        np.testing.assert_array_equal(got, np.ones(8, np.float32))


def test_local_hbm_proxy_keys_match_reference():
    import jax

    from tpu_dra.workloads.allreduce import local_hbm_bandwidth

    want = local_hbm_bandwidth(nbytes=1 << 16, iters=4, warmup=1, reps=1,
                               device=jax.devices()[0])
    got = tar.local_hbm_bandwidth(nbytes=1 << 16, iters=4, warmup=1, reps=1,
                                  device="cpu")
    assert set(got) == set(want)
    assert got["payload_mib"] == want["payload_mib"]
    assert got["hbm_proxy_gbps"] > 0


def _workload_task(plan, devices):
    from tpu_dra_torch.infra.metrics import PSUM_BW
    from tpu_dra_torch.workloads import meshbuild

    before = PSUM_BW._n
    rec = meshbuild.launch_workload("allreduce", plan, devices,
                                    nbytes_per_device=1 << 16, iters=2)
    return rec, PSUM_BW._n - before


def _env(n):
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.topology.meshexport import export_topology_env

    gpus = gpuinfo.default_fake_gpus(8)[:n]
    env = dict(export_topology_env(gpus))
    env["CUDA_VISIBLE_DEVICES"] = ",".join(g.uuid for g in gpus)
    env["GPU_VISIBLE_INDICES"] = ",".join(str(g.index) for g in gpus)
    return env


def test_workload_record_and_metric(pool):
    """launch_workload("allreduce") on a two-GPU plan, inside the pool's
    group: the reference's launcher keys, and the rate observed on the
    psum histogram of the rank that ran it."""
    from tpu_dra_torch.topology.meshexport import plan_from_env
    from tpu_dra_torch.workloads import meshbuild

    env = _env(WORLD)
    plan = plan_from_env(env)
    recs = pool.run(_workload_task, plan,
                    meshbuild.devices_from_env(env, "cpu"))
    for rec, observed in recs:
        assert set(rec) == {"algo_gbps", "bus_gbps", "n_devices"}
        assert rec["n_devices"] == WORLD and rec["algo_gbps"] > 0
        assert observed == 1


def test_bench_psum_one_gpu_matches_reference_keys():
    """bench_psum on a one-GPU claim env: the reference's keys (its
    bench_psum on one CPU device), zero rates with the skip reason, the
    local proxy and a full coverage."""
    import jax

    import bench as jax_bench

    want = jax_bench.bench_psum({"devices": jax.devices()[:1]}, "0")
    got = tbench.bench_psum(_env(1), device_type="cpu")
    assert set(got) == set(want)
    assert got["algo_gbps"] == 0.0 and got["bus_gbps"] == 0.0
    assert "no NVLink collective" in got["skip_reason"]
    assert got["coverage"] == "1/1" and got["local_hbm_proxy_gbps"] > 0


def test_bench_psum_counts_coverage_against_the_allocation():
    env = _env(1)
    got = tbench.bench_psum(env, allocated_gpus=4, device_type="cpu")
    assert got["coverage"] == "1/4"
    assert "4 GPUs" in got["skip_reason"]
    with pytest.raises(RuntimeError, match="no claimed GPU"):
        tbench.bench_psum({"CUDA_VISIBLE_DEVICES": ""}, device_type="cpu")
