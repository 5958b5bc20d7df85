"""The port's fake multi-worker GPU slice: ``default_fake_gpus(...,
worker_index, total_workers)`` and ``testing.MeshSliceHarness``, against
the reference's ``default_fake_chips`` and ``MeshSliceHarness``.

- layout: worker w of W holds the block w·n … w·n+n−1 of one
  "{W·n}x1x1" NVLink domain, as the reference's fake chips hold their
  block of one slice; one worker keeps the node layout;
- the harness plans 2×4 and 3×4 GPU slices (8 and 12 GPUs over 2 and 3
  workers, contiguous, both workers' blocks in the plan), the
  counterparts of tests/test_meshbuild.py's TestHarnessPlan;
- the placement A/B needs no port: inside one NVLink domain every pair
  of GPUs is one hop apart, so a contiguous and a scattered claim of the
  same harness read the same modeled GB/s, where the reference's two
  cuboids of one torus read different ones.
"""

import pytest
import torch

from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.native.gpuinfo import default_fake_gpus
from tpu_dra_torch.testing import MeshSliceHarness
from tpu_dra_torch.topology import meshexport as me

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


class TestFakeLayout:
    @pytest.mark.parametrize("workers,per", [(2, 4), (3, 4), (2, 8)])
    def test_worker_blocks_tile_one_domain(self, workers, per):
        from tpu_dra.native.tpuinfo import default_fake_chips

        seen = set()
        for w in range(workers):
            gpus = default_fake_gpus(per, worker_index=w,
                                     total_workers=workers)
            assert [g.coords for g in gpus] == [
                (w * per + i, 0, 0) for i in range(per)]
            assert {g.slice_topology for g in gpus} == {
                f"{workers * per}x1x1"}
            assert [g.index for g in gpus] == list(range(per))
            assert all(g.worker_index == w for g in gpus)
            seen.update(g.coords for g in gpus)
            # The reference's fake chips: the same block of a global
            # coordinate space, disjoint per worker.
            chips = default_fake_chips(per, "v5e", worker_index=w,
                                       total_workers=workers)
            assert len({c.coords for c in chips}) == per
        assert len(seen) == workers * per

    def test_one_worker_keeps_the_node_layout(self):
        assert default_fake_gpus(4, total_workers=1) == default_fake_gpus(4)

    def test_worker_index_outside_the_slice_is_refused(self):
        with pytest.raises(ValueError):
            default_fake_gpus(4, worker_index=2, total_workers=2)

    def test_uuids_distinct_across_workers(self):
        uuids = {g.uuid for w in range(3)
                 for g in default_fake_gpus(4, worker_index=w,
                                            total_workers=3)}
        assert len(uuids) == 12


class TestHarnessPlan:
    def test_multi_worker_harness_yields_contiguous_plan(self):
        h = MeshSliceHarness(n_workers=2, gpus_per_worker=4)
        try:
            envs = h.worker_envs()
            plan = me.plan_from_worker_envs(envs)
        finally:
            h.close()
        assert plan.n_devices == 8
        assert plan.n_workers == 2
        assert plan.contiguous
        assert plan.hop_mean == 1.0
        assert plan.modeled_nvlink_gbps > 0
        assert {k[0] for k in plan.gpu_keys} == {0, 1}
        assert [e["GPU_WORKER_ID"] for e in envs] == ["0", "1"]
        assert {e["GPU_FABRIC_TOPOLOGY"] for e in envs} == {"8x1x1"}
        assert all(e["GPU_PROCESS_COUNT"] == "2" for e in envs)
        assert all(e["GPU_COORDINATOR_ADDRESS"].endswith(":8476")
                   for e in envs)

    def test_three_worker_harness(self):
        h = MeshSliceHarness(n_workers=3, gpus_per_worker=4)
        try:
            plan = me.plan_from_worker_envs(h.worker_envs())
        finally:
            h.close()
        assert plan.n_devices == 12
        assert plan.n_workers == 3
        assert plan.contiguous
        assert {k[0] for k in plan.gpu_keys} == {0, 1, 2}

    def test_close_unprepares_and_removes_the_tree(self):
        import os

        h = MeshSliceHarness(n_workers=2, gpus_per_worker=2)
        h.worker_envs()
        assert all(s.prepared_claim_uids() for s in h.states)
        tmp = h.tmp
        h.close()
        assert not os.path.exists(tmp)

    def test_node_layout_workers_overlap_and_are_refused(self):
        """Why the layout is needed: two workers whose GPUs both sit at
        (0..n-1, 0, 0) cannot be planned as one slice."""
        h = MeshSliceHarness(n_workers=2, gpus_per_worker=4)
        try:
            envs = h.worker_envs()
        finally:
            h.close()
        envs[1] = dict(envs[1], GPU_COORDS=envs[0]["GPU_COORDS"])
        with pytest.raises(me.MeshBuildError):
            me.plan_from_worker_envs(envs)


class TestPlacementAB:
    def test_one_domain_reads_the_same_for_both_placements(self):
        h = MeshSliceHarness(n_workers=1, gpus_per_worker=8)
        try:
            plan_c = me.plan_from_env(h.prepare_claim(0, [0, 1, 2, 3]))
            plan_f = me.plan_from_env(h.prepare_claim(0, [0, 2, 4, 6]))
        finally:
            h.close()
        assert plan_c.n_devices == plan_f.n_devices == 4
        assert plan_c.hop_mean == plan_f.hop_mean == 1.0
        assert plan_c.modeled_nvlink_gbps == plan_f.modeled_nvlink_gbps

    def test_reference_cuboids_read_differently(self):
        from tpu_dra.testing import MeshSliceHarness as RefHarness
        from tpu_dra.topology import meshexport as ref_me

        h = RefHarness(n_workers=1, chips_per_worker=64, generation="v5p",
                       slice_id="ab")
        try:
            chips = h.backends[0].chips()
            contig = sorted(c.index for c in chips
                            if all(v in (0, 1) for v in c.coords))
            frag = sorted(c.index for c in chips
                          if all(v in (0, 2) for v in c.coords))
            plan_c = ref_me.plan_from_env(
                h.prepare_claim(0, chip_indices=contig))
            plan_f = ref_me.plan_from_env(
                h.prepare_claim(0, chip_indices=frag))
        finally:
            h.close()
        assert plan_c.n_devices == plan_f.n_devices == 8
        assert plan_c.modeled_ici_gbps != plan_f.modeled_ici_gbps
