"""The main path closed on the CPU: a claim prepared through
tpu_dra_torch, its CDI env read back, planned, and the torch train step
run on the plan's devices — against the reference's own path (a claim
prepared by tpu_dra's DeviceState, its env planned by tpu_dra's
meshexport, a JAX mesh laid by tpu_dra's meshbuild, and the reference's
jitted train step on it).

A fake 8-GPU HGX H100 node on the port's side; reference chips with the
same indices, UUIDs, coordinates and topology on the reference's. The
same weights (the reference's, carried across by params_from_jax) and
tokens go into both train steps; the losses of two SGD steps must agree
within 1e-4 relative (fp32: the same function summed in different
orders). Claims of 1 GPU (attention through the reference's Pallas
kernels in interpret mode and the port's kernel wrappers' plain
versions) and of all 8 GPUs (the reference's step data-parallel over an
8-device mesh, the port's on the plan's rank-0 device; plain attention
on both).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dra.api import types as ref_types
from tpu_dra.cdi.handler import CDIHandler as RefCDI
from tpu_dra.native.tpuinfo import FakeBackend as RefFake
from tpu_dra.topology import meshexport as rme
from tpu_dra.tpuplugin.checkpoint import CheckpointManager as RefCkpt
from tpu_dra.tpuplugin.device_state import DeviceState as RefState
from tpu_dra.workloads import meshbuild as rmb
from tpu_dra.workloads import model as jm
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.cdi.handler import CDIHandler as PortCDI
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager as PortCkpt
from tpu_dra_torch.gpuplugin.device_state import DeviceState as PortState
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.native import gpuinfo
from tpu_dra_torch.topology import meshexport as me
from tpu_dra_torch.workloads import meshbuild as mb
from tpu_dra_torch.workloads import model as tm

from test_torch_cdi import reference_chips

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

SMALL = dict(vocab=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq=64)
LR = 0.1
STEPS = 2
TOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


def claim(driver, prefix, devices):
    return {"metadata": {"uid": "claim-1", "name": "c", "namespace": "ns"},
            "status": {"allocation": {"devices": {"results": [
                {"request": "r", "driver": driver, "pool": "node-a",
                 "device": f"{prefix}-{i}"} for i in devices],
                "config": []}}}}


def prepared_envs(tmp, devices):
    """The claim env each side's container would see: the port's through
    its CDI handler's runtime view of the claim's CDI ids, the
    reference's from its claim spec (its per-chip spec adds only
    TPU_CHIP_<i>_UUID)."""
    gpus = gpuinfo.default_fake_gpus(8)
    port_cdi = PortCDI(str(tmp / "port-cdi"))
    port = PortState(backend=gpuinfo.FakeBackend(gpus), cdi=port_cdi,
                     checkpoints=PortCkpt(str(tmp / "port-plugin")),
                     driver_name=port_types.GPU_DRIVER_NAME,
                     node_name="node-a")
    ref_cdi = RefCDI(str(tmp / "ref-cdi"), driver_root=str(tmp / "drv"))
    ref = RefState(backend=RefFake(reference_chips(gpus)), cdi=ref_cdi,
                   checkpoints=RefCkpt(str(tmp / "ref-plugin")),
                   driver_name=ref_types.TPU_DRIVER_NAME, node_name="node-a")
    try:
        res = port.prepare(claim(port_types.GPU_DRIVER_NAME, "gpu", devices))
        assert res.error == ""
        ids = [i for d in res.devices for i in d.cdi_device_ids]
        port_env = port_cdi.container_edits(ids)["env"]
        ref_res = ref.prepare(claim(ref_types.TPU_DRIVER_NAME, "chip",
                                    devices))
        assert ref_res.error == ""
        with open(ref_cdi.claim_spec_path("claim-1")) as f:
            spec = json.load(f)
        ref_env = dict(e.split("=", 1) for e in
                       spec["devices"][0]["containerEdits"]["env"])
    finally:
        port.close()
        ref.close()
    return gpus, port_env, ref_env


def reference_losses(ref_env, params, tokens, attn_impl):
    """The reference's path from its claim env: plan, a (data, model)
    mesh over the plan's devices, its jitted SGD step."""
    plan = rme.plan_from_env(ref_env)
    n = plan.n_devices
    mesh = rmb.mesh_from_plan(plan, jax.devices()[:n],
                              axis_names=("data", "model"), shape=(n, 1))
    cfg = jm.ModelConfig(**SMALL, dtype=jnp.float32, attn_impl=attn_impl)
    step = jm.make_train_step(jm.TransformerLM(cfg), mesh, lr=LR)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, jnp.asarray(tokens))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("devices,attn", [
    ([5], ("flash_interpret", "flash")),
    (list(range(8)), ("auto", "auto")),
], ids=["one-gpu", "eight-gpus"])
def test_claim_env_drives_the_train_step(tmp_path, devices, attn):
    if len(jax.devices()) < len(devices):
        pytest.fail("the reference's mesh needs the 8-device CPU platform")
    gpus, env, ref_env = prepared_envs(tmp_path, devices)

    # The env a container sees: the claim's GPUs by UUID, their fabric.
    uuids = [gpus[i].uuid for i in devices]
    assert env["CUDA_VISIBLE_DEVICES"].split(",") == uuids
    assert env["GPU_VISIBLE_INDICES"] == ",".join(map(str, devices))
    assert env["GPU_FABRIC_TOPOLOGY"] == "8x1x1"
    assert all(env[f"GPU_{i}_UUID"] == gpus[i].uuid for i in devices)

    plan = me.plan_from_env(env)
    ref_plan = rme.plan_from_env(ref_env)
    assert plan.coords == ref_plan.coords == tuple(
        (i, 0, 0) for i in devices)
    assert plan.gpu_keys == ref_plan.chip_keys
    assert plan.order == ref_plan.order
    torch_devices = mb.devices_from_env(env, "cpu")
    assert len(torch_devices) == len(devices)

    cfg_j = jm.ModelConfig(**SMALL, dtype=jnp.float32)
    params_j = jm.init_params(jax.random.PRNGKey(7), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    tokens = np.random.RandomState(8).randint(
        0, SMALL["vocab"], (8, SMALL["max_seq"]))

    cfg_t = tm.ModelConfig(**SMALL, dtype=torch.float32, attn_impl=attn[1])
    res = mb.launch_workload(
        "train", plan, torch_devices, cfg=cfg_t, steps=STEPS, lr=LR,
        params=tm.params_from_jax(tree, cfg_t, "cpu"), tokens=tokens)
    assert res["device"] == "cpu" and res["n_devices"] == len(devices)
    assert res["batch"] == 8 and res["seq"] == SMALL["max_seq"]

    want = reference_losses(ref_env, params_j, tokens, attn[0])
    got = res["losses"]
    assert len(got) == len(want) == STEPS
    assert got[1] < got[0]   # the SGD step moved the weights
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL * abs(w), (got, want)


def test_unprepared_claim_leaves_nothing(tmp_path):
    cdi = PortCDI(str(tmp_path / "cdi"))
    ckpt_dir = str(tmp_path / "plugin")
    state = PortState(backend=gpuinfo.FakeBackend(), cdi=cdi,
                      checkpoints=PortCkpt(ckpt_dir),
                      driver_name=port_types.GPU_DRIVER_NAME,
                      node_name="node-a")
    try:
        res = state.prepare(claim(port_types.GPU_DRIVER_NAME, "gpu", [0]))
        assert res.error == "" and cdi.claim_spec_exists("claim-1")
        assert state.unprepare("claim-1") is None
        assert not cdi.claim_spec_exists("claim-1")
        assert state.prepared_claim_uids() == []
    finally:
        state.close()
    reloaded = PortCkpt(ckpt_dir)
    try:
        cp = reloaded.load()
        assert cp is None or cp.claims == {}
    finally:
        reloaded.close()
