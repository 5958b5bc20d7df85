"""bench_shared_claim (tpu_dra_torch.bench) on the CPU: one claim of the
fake node's GPU 2, prepared over the plugin's framed socket and consumed
by two claim-child processes at once (``python -m tpu_dra_torch.bench
claim-child --device-type cpu``, a small model), as the card's
shared_claim and mps phases run the flagship. The counterpart of the
reference's shared-claim demo (demo/specs/tpu-test2.yaml: one claim, two
containers) and of its multiprocess config (tpu-test-multiprocess.yaml).

The tenants' losses must equal the solo tenant's exactly (the same
weights, tokens and thread count in fp32). The MPS outcomes: "a" without
the control binary; "b" where NVML refuses the compute mode, unwound;
and on the CPU, where no tenant reaches the daemon, the client check
must refuse the run (what a wrong pipe directory would look like on a
card).
"""

import json
import sys

import pytest
import torch

from tpu_dra_torch import bench
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.testing import MPS_STANDIN

from test_torch_sharing import RefusingBackend

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

SMALL = json.dumps(dict(vocab=128, d_model=128, n_heads=2, n_layers=2,
                        d_ff=256, max_seq=128, dtype="float32"))
CHILD = [sys.executable, "-m", "tpu_dra_torch.bench", bench.CLAIM_CHILD,
         "--config", SMALL]
MPS = bench.mps_shared_config(3 << 29)   # a 1.5 GiB tenant -> 3 GiB


@pytest.fixture(autouse=True)
def _reset_port_registries(monkeypatch):
    # Each tenant on one thread: two tenants at the machine's thread count
    # each spin against each other.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


def run(backend=None, **kw):
    return bench.bench_shared_claim(backend or gpuinfo.FakeBackend(),
                                    device_type="cpu", child_argv=CHILD,
                                    gpu_index=2, **kw)


def tenant(pid, start, end):
    return {"pid": pid, "losses": [1.0], "uuid": None,
            "claim_uuids": ["GPU-1"], "window": [start, end]}


@pytest.mark.parametrize("end_b,ok", [(10.9, True), (11.0, True),
                                      (11.2, False), (5.0, False)])
def test_overlap_rule(end_b, ok):
    """On a card each window must overlap the other's for MIN_OVERLAP
    (0.9) of its own length: B of [0, end_b] against A of [0, 10]."""
    recs = [{**tenant(1, 0.0, 10.0), "uuid": "GPU-1"},
            {**tenant(2, 0.0, end_b), "uuid": "GPU-1"}]
    if ok:
        assert min(bench._check_tenants(recs, "GPU-1", "cuda")) >= 0.9
    else:
        with pytest.raises(RuntimeError, match="did not share"):
            bench._check_tenants(recs, "GPU-1", "cuda")


def test_tenant_on_another_gpu_refused():
    with pytest.raises(RuntimeError, match="the claim holds GPU-2"):
        bench._check_tenants([tenant(1, 0, 1)], "GPU-2", "cpu")


def test_mps_config_limit():
    assert MPS["sharing"]["mpsConfig"] == {
        "defaultActiveThreadPercentage": 50,
        "defaultPinnedDeviceMemoryLimit": "3Gi"}
    limit = bench.mps_shared_config((20 << 30) + 1)
    assert limit["sharing"]["mpsConfig"][
        "defaultPinnedDeviceMemoryLimit"] == "31Gi"


def test_runtime_env_rewrites_mounted_paths():
    env, rewritten = bench.runtime_env({
        "env": {"CUDA_MPS_PIPE_DIRECTORY": "/mps/pipe", "A": "/mpsx",
                "B": "/lib/x"},
        "mounts": [{"containerPath": "/mps", "hostPath": "/h/c1"},
                   {"containerPath": "/lib/x", "hostPath": "/lib/x"}]})
    assert env == {"CUDA_MPS_PIPE_DIRECTORY": "/h/c1/pipe", "A": "/mpsx",
                   "B": "/lib/x"}
    assert rewritten == [("CUDA_MPS_PIPE_DIRECTORY", "/mps/pipe",
                          "/h/c1/pipe")]


def test_two_tenants_share_one_claim():
    res = run()
    assert res["ran"] and res["n_tenants"] == 2
    assert len(res["overlap_shares"]) == 2
    assert min(res["overlap_shares"]) >= bench.MIN_OVERLAP_CPU
    solo = res["solo"]["losses"]
    assert len(solo) == bench.SHARED_STEPS and solo[-1] < solo[0]
    for t in res["tenants"]:
        assert t["losses"] == solo
        assert len(t["step_times_s"]) == bench.SHARED_STEPS
        assert set(t["launches"].values()) == {0}   # plain versions on the CPU
    assert res["env"]["CUDA_VISIBLE_DEVICES"] == res["claim_uuid"]
    assert res["aggregate_tokens_per_s"] == pytest.approx(
        sum(t["tokens_per_s"] for t in res["tenants"]))


def test_mps_without_control_binary_is_outcome_a(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    res = run(config=MPS)
    assert res["ran"] is False and res["outcome"] == "a"
    assert "nvidia-cuda-mps-control" in res["reason"]


def test_mps_refused_compute_mode_is_outcome_b():
    res = run(RefusingBackend(), config=MPS, mps_binary=MPS_STANDIN)
    assert res["ran"] is False and res["outcome"] == "b"
    assert "nvmlDeviceSetComputeMode" in res["error"]
    assert "Not Supported" in res["error"]
    assert res["left"] == {"deployments": [], "daemon_processes": [],
                           "claim_spec": False, "checkpoint_entry": False,
                           "compute_mode": gpuinfo.NVML_COMPUTEMODE_DEFAULT}


def test_mps_tenants_outside_the_daemon_refused():
    """CPU tenants never connect to the daemon, as tenants with a wrong
    CUDA_MPS_PIPE_DIRECTORY would not: the run must fail, not pass as
    shared."""
    with pytest.raises(RuntimeError, match="listed 0 clients while 2"):
        run(config=MPS, mps_binary=MPS_STANDIN,
            solo={"max_memory_allocated": None})
