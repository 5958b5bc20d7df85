"""Port parity: tpu_dra_torch.native.gpuinfo (GPU discovery) against
tpu_dra.native.tpuinfo (TPU chip discovery), on the CPU.

- FakeBackend: the 8-GPU HGX H100 inventory, and the same settings
  bookkeeping as the reference's fake (time slice, exclusive mode, the
  KeyError for an unknown index).
- NativeBackend over a stub NVML function table standing in for the
  CDLL: struct decoding (nvmlPciInfo_t's layout, memory, compute
  capability), NVML_ERROR_NOT_SUPPORTED from nvmlDeviceGetMigMode read as
  "no MIG", an init failure that raises, and the compute-mode setter;
  the NVLink clique (a fabric clique id, a node-local NVLink clique, a
  GPU with no active link or no NVLink answer alone), a GPU without a
  bus id refused; the health event set (registration, NOT_SUPPORTED
  GPUs listed, XID and ECC events mapped to their GPU, the timeout).
- The fake's injected health events, against the reference fake's.
- get_backend: fake only when asked; native otherwise, with no fallback.

Exact comparisons: these are bookkeeping and decoding, no arithmetic.
"""

import ctypes
import types

import pytest
import torch

from tpu_dra.native import tpuinfo
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra.faults import FAULTS as PORT_FAULTS
from tpu_dra_torch.native import gpuinfo

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests


@pytest.fixture(autouse=True)
def _reset_port_registries():
    port_gates.Features.reset()
    PORT_FAULTS.reset()
    yield
    port_gates.Features.reset()
    PORT_FAULTS.reset()


class TestFakeInventory:
    def test_hgx_h100_node(self):
        gpus = gpuinfo.FakeBackend().gpus()
        assert len(gpus) == 8
        assert [g.index for g in gpus] == list(range(8))
        assert {g.product_name for g in gpus} == {"NVIDIA H100 80GB HBM3"}
        assert {g.compute_capability for g in gpus} == {(9, 0)}
        assert {g.memory_bytes for g in gpus} == {80 << 30}
        assert len({g.uuid for g in gpus}) == 8
        assert all(g.uuid.startswith("GPU-") for g in gpus)
        assert [g.dev_path for g in gpus] == [f"/dev/nvidia{i}"
                                              for i in range(8)]
        assert {g.generation for g in gpus} == {"hopper"}
        # One NVLink clique: a line in PCI order, topology declared.
        assert [g.coords for g in gpus] == [(i, 0, 0) for i in range(8)]
        assert {g.slice_topology for g in gpus} == {"8x1x1"}
        assert len({g.clique_id for g in gpus}) == 1

    def test_coords_follow_pci_order_within_each_clique(self):
        base = gpuinfo.default_fake_gpus(4)
        shuffled = [
            gpuinfo.Gpu(index=g.index, uuid=g.uuid, minor=g.minor,
                        pci_bus_id=bus, memory_bytes=g.memory_bytes,
                        product_name=g.product_name,
                        compute_capability=g.compute_capability,
                        clique_id=clique)
            for g, bus, clique in zip(
                base, ("0000:9A:00.0", "0000:18:00.0", "0000:3B:00.0",
                       "0000:AB:00.0"), ("a", "a", "a", "b"))]
        placed = gpuinfo.assign_fabric_coords(shuffled)
        assert [g.coords for g in placed] == [(2, 0, 0), (0, 0, 0),
                                              (1, 0, 0), (0, 0, 0)]
        assert [g.slice_topology for g in placed] == ["3x1x1"] * 3 \
            + ["1x1x1"]

    def test_settings_bookkeeping_matches_reference_fake(self):
        ref = tpuinfo.FakeBackend(tpuinfo.default_fake_chips(8, "v5e"))
        port = gpuinfo.FakeBackend()
        for backend in (ref, port):
            backend.set_timeslice(3, 2)
            backend.set_exclusive_mode(5, True)
            backend.set_exclusive_mode(5, False)
        assert port.timeslices == ref.timeslices == {3: 2}
        assert port.exclusive == ref.exclusive == {5: False}
        with pytest.raises(KeyError):
            ref.set_exclusive_mode(8, True)
        with pytest.raises(KeyError):
            port.set_exclusive_mode(8, True)
        with pytest.raises(KeyError):
            port.get_gpu(8)


# ---------------------------------------------------------------------------
# NativeBackend over a stub NVML
# ---------------------------------------------------------------------------

NOT_SUPPORTED = gpuinfo.NVML_ERROR_NOT_SUPPORTED


def _recording(table):
    """A library stand-in: each symbol of `table` as an attribute that
    records its name in `lib.calls` and runs the function."""
    lib = types.SimpleNamespace(calls=[])

    def recorded(sym, fn):
        def call(*args):
            lib.calls.append(sym)
            return fn(*args)
        return call

    for sym, fn in table.items():
        setattr(lib, sym, recorded(sym, fn))
    return lib


def stub_cuda(devices):
    """A stand-in for ctypes.CDLL("libcuda.so.1"): `devices` is a list of
    (PCI bus id, 16 UUID bytes) in CUDA ordinal order."""

    def count(ref):
        ref._obj.value = len(devices)
        return 0

    def get(ref, ordinal):
        ref._obj.value = ordinal
        return 0

    def uuid(ref, dev):
        ref._obj.bytes[:] = list(devices[dev][1])
        return 0

    def bus(buf, n, dev):
        buf.value = devices[dev][0].encode()
        return 0

    table = {"cuInit": lambda flags: 0, "cuDeviceGetCount": count,
             "cuDeviceGet": get, "cuDeviceGetUuid_v2": uuid,
             "cuDeviceGetPCIBusId": bus}
    assert set(table) == set(gpuinfo.CUDA_SYMBOLS)
    return _recording(table)


def stub_nvml(gpus, init_rc=0, mig_rc=None, pci_rc=0, events=(),
              register_rc=None, event_set_rc=0):
    """A stand-in for ctypes.CDLL("libnvidia-ml.so.1"): one Python function
    per NVML symbol, filling the caller's buffers as NVML does. `gpus` is
    a list of dicts; `mig_rc` maps a GPU index to the return code of
    nvmlDeviceGetMigMode; `pci_rc` is nvmlDeviceGetPciInfo_v3's. A GPU's
    "fabric" is (rc, status, state, clique id, cluster UUID bytes) of
    nvmlDeviceGetGpuFabricInfo (default NOT_SUPPORTED), its "links" the
    state of each NVLink (default one active link), or an int: the code
    nvmlDeviceGetNvLinkState answers for every link. `events` are
    (GPU index or None, event type, data) served by nvmlEventSetWait_v2
    in order, then NVML_ERROR_TIMEOUT; `register_rc` maps a GPU index to
    nvmlDeviceRegisterEvents' code. Records every call in `lib.calls`."""
    compute_modes = {}
    mig_rc = mig_rc or {}
    register_rc = register_rc or {}
    pending = list(events)
    registered = {}

    def gpu(h):
        return gpus[h.value - 1]

    def init():
        return init_rc

    def error_string(code):
        return {999: b"Unknown Error", 9: b"Driver Not Loaded"}.get(
            code, b"error")

    def count(ref):
        ref._obj.value = len(gpus)
        return 0

    def handle(i, ref):
        if i >= len(gpus):
            return 2   # NVML_ERROR_INVALID_ARGUMENT
        ref._obj.value = i + 1
        return 0

    def uuid(h, buf, n):
        assert n == 96
        buf.value = gpu(h)["uuid"].encode()
        return 0

    def name(h, buf, n):
        buf.value = gpu(h)["name"].encode()
        return 0

    def minor(h, ref):
        ref._obj.value = gpu(h)["minor"]
        return 0

    def pci(h, ref):
        if pci_rc:
            return pci_rc
        info = ref._obj
        info.busIdLegacy = gpu(h)["bus"][-12:].encode()
        info.domain, info.bus = 0, int(gpu(h)["bus"].split(":")[1], 16)
        info.busId = gpu(h)["bus"].encode()
        return 0

    def memory(h, ref):
        ref._obj.total = gpu(h)["memory"]
        ref._obj.free = gpu(h)["memory"] // 2
        return 0

    def capability(h, major, minor_):
        major._obj.value, minor_._obj.value = gpu(h)["cc"]
        return 0

    def mig(h, current, pending):
        rc = mig_rc.get(h.value - 1, 0)
        if rc == 0:
            current._obj.value = pending._obj.value = gpu(h)["mig"]
        return rc

    def set_mode(h, mode):
        compute_modes[h.value - 1] = mode
        return 0 if gpu(h).get("root", True) else 4   # NO_PERMISSION

    def fabric(h, ref):
        rc, status, state, clique, cluster = gpu(h).get(
            "fabric", (NOT_SUPPORTED, 0, 0, 0, bytes(16)))
        if rc == 0:
            info = ref._obj
            info.status, info.state, info.cliqueId = status, state, clique
            info.clusterUuid[:] = list(cluster)
        return rc

    def nvlink(h, link, ref):
        links = gpu(h).get("links", [1])
        if isinstance(links, int):
            return links
        if link >= len(links):
            return 2   # NVML_ERROR_INVALID_ARGUMENT: past the last link
        ref._obj.value = links[link]
        return 0

    def event_set_create(ref):
        ref._obj.value = 0xE5E7
        return event_set_rc

    def register(h, mask, event_set):
        assert event_set.value == 0xE5E7
        rc = register_rc.get(h.value - 1, 0)
        if rc == 0:
            registered[h.value - 1] = mask
        return rc

    def wait(event_set, ref, timeout_ms):
        if not pending:
            return gpuinfo.NVML_ERROR_TIMEOUT
        index, kind, data = pending.pop(0)
        ev = ref._obj
        ev.device = None if index is None else index + 1
        ev.eventType, ev.eventData = kind, data
        return 0

    table = {
        "nvmlInit_v2": init, "nvmlShutdown": lambda: 0,
        "nvmlErrorString": error_string,
        "nvmlDeviceGetCount_v2": count,
        "nvmlDeviceGetHandleByIndex_v2": handle,
        "nvmlDeviceGetUUID": uuid, "nvmlDeviceGetName": name,
        "nvmlDeviceGetMinorNumber": minor,
        "nvmlDeviceGetPciInfo_v3": pci,
        "nvmlDeviceGetMemoryInfo": memory,
        "nvmlDeviceGetCudaComputeCapability": capability,
        "nvmlDeviceGetMigMode": mig,
        "nvmlDeviceSetComputeMode": set_mode,
        "nvmlDeviceGetGpuFabricInfo": fabric,
        "nvmlDeviceGetNvLinkState": nvlink,
        "nvmlEventSetCreate": event_set_create,
        "nvmlDeviceRegisterEvents": register,
        "nvmlEventSetWait_v2": wait,
        "nvmlEventSetFree": lambda event_set: 0,
    }
    assert set(table) == set(gpuinfo.NVML_SYMBOLS)
    lib = _recording(table)
    lib.compute_modes = compute_modes
    lib.registered = registered
    return lib


def h100(i, **kw):
    return {"uuid": f"GPU-{i:08x}-1111-2222-3333-444444444444",
            "name": "NVIDIA H100 80GB HBM3", "minor": i,
            "bus": f"00000000:{0x18 + 0x10 * i:02X}:00.0",
            "memory": 85520809984, "cc": (9, 0), "mig": 0, **kw}


class TestNativeBackend:
    def test_pci_info_layout_is_nvmls(self):
        # nvmlPciInfo_t: busIdLegacy[16] first, five unsigned ints, then
        # busId[32] last (68 bytes).
        assert ctypes.sizeof(gpuinfo.NvmlPciInfo) == 68
        assert gpuinfo.NvmlPciInfo.busIdLegacy.offset == 0
        assert gpuinfo.NvmlPciInfo.domain.offset == 16
        assert gpuinfo.NvmlPciInfo.busId.offset == 36
        assert ctypes.sizeof(gpuinfo.NvmlMemory) == 24

    def test_decodes_inventory(self):
        lib = stub_nvml([h100(0), h100(1, minor=5, mig=1)])
        backend = gpuinfo.NativeBackend(lib=lib)
        gpus = backend.gpus()
        assert [g.index for g in gpus] == [0, 1]
        g0, g1 = gpus
        assert g0.uuid == "GPU-00000000-1111-2222-3333-444444444444"
        assert g0.product_name == "NVIDIA H100 80GB HBM3"
        assert g0.pci_bus_id == "00000000:18:00.0"  # busId, not the legacy
        assert g0.memory_bytes == 85520809984
        assert g0.compute_capability == (9, 0)
        assert (g0.mig_mode, g1.mig_mode) == (False, True)
        assert g1.minor == 5 and g1.dev_path == "/dev/nvidia5"
        assert [g.coords for g in gpus] == [(0, 0, 0), (1, 0, 0)]
        assert {g.slice_topology for g in gpus} == {"2x1x1"}
        assert backend.kind == "native"
        backend.close()
        assert lib.calls[0] == "nvmlInit_v2"
        assert lib.calls[-1] == "nvmlShutdown"

    def test_inventory_read_once(self):
        lib = stub_nvml([h100(0)])
        backend = gpuinfo.NativeBackend(lib=lib)
        backend.gpus()
        n = len(lib.calls)
        assert backend.get_gpu(0).index == 0
        assert len(lib.calls) == n

    def test_mig_not_supported_is_no_mig(self):
        lib = stub_nvml([h100(0), h100(1)], mig_rc={1: NOT_SUPPORTED})
        gpus = gpuinfo.NativeBackend(lib=lib).gpus()
        assert [g.mig_mode for g in gpus] == [False, None]

    def test_other_mig_error_raises(self):
        lib = stub_nvml([h100(0)], mig_rc={0: 999})
        with pytest.raises(gpuinfo.NvmlError, match="nvmlDeviceGetMigMode"):
            gpuinfo.NativeBackend(lib=lib).gpus()

    def test_init_failure_raises(self):
        lib = stub_nvml([h100(0)], init_rc=9)
        with pytest.raises(gpuinfo.NvmlError,
                           match="nvmlInit_v2.*Driver Not Loaded"):
            gpuinfo.NativeBackend(lib=lib)
        assert lib.calls == ["nvmlInit_v2", "nvmlErrorString"]

    def test_exclusive_mode_is_compute_mode(self):
        lib = stub_nvml([h100(0), h100(1, root=False)])
        backend = gpuinfo.NativeBackend(lib=lib)
        backend.set_exclusive_mode(0, True)
        assert lib.compute_modes[0] == gpuinfo.NVML_COMPUTEMODE_EXCLUSIVE_PROCESS
        backend.set_exclusive_mode(0, False)
        assert lib.compute_modes[0] == gpuinfo.NVML_COMPUTEMODE_DEFAULT
        with pytest.raises(gpuinfo.NvmlError, match="NVML error 4"):
            backend.set_exclusive_mode(1, True)

    def test_withheld_pci_filled_from_cuda_driver_by_uuid(self):
        """An NVML that answers NOT_SUPPORTED for PCI info (as the H100
        host's does) gets the bus ids from the CUDA driver API, matched
        by UUID whatever the CUDA ordinal order, and the clique is laid
        out in that bus order."""
        lib = stub_nvml([h100(0), h100(1), h100(2)], pci_rc=NOT_SUPPORTED)
        uuid = [bytes.fromhex(f"0000000{i}111122223333444444444444")
                for i in range(3)]
        cuda = stub_cuda([("0000:18:00.0", uuid[1]),
                          ("0000:99:00.0", uuid[0]),
                          ("0000:4C:00.0", uuid[2])])
        backend = gpuinfo.NativeBackend(lib=lib, cuda_lib=cuda)
        gpus = backend.gpus()
        assert [g.pci_bus_id for g in gpus] == ["0000:99:00.0",
                                                "0000:18:00.0",
                                                "0000:4C:00.0"]
        assert [g.uuid for g in gpus] == [h100(i)["uuid"] for i in range(3)]
        assert [g.coords for g in gpus] == [(2, 0, 0), (0, 0, 0),
                                            (1, 0, 0)]
        assert backend.filled == {i: ["pci_bus_id"] for i in range(3)}
        assert cuda.calls[0] == "cuInit"

    def test_gpu_without_bus_id_refused(self):
        """A GPU that NVML withholds the bus id of and this process's CUDA
        does not see cannot be placed in its clique: refused, naming it."""
        lib = stub_nvml([h100(0), h100(1)], pci_rc=NOT_SUPPORTED)
        uuid0 = bytes.fromhex("00000000111122223333444444444444")
        cuda = stub_cuda([("0000:18:00.0", uuid0)])
        backend = gpuinfo.NativeBackend(lib=lib, cuda_lib=cuda)
        with pytest.raises(RuntimeError,
                           match=r"GPU 1 \(GPU-00000001.*does not see it"):
            backend.gpus()
        g = gpuinfo.default_fake_gpus(2)
        with pytest.raises(ValueError, match="GPU 1 .* no PCI bus id"):
            gpuinfo.assign_fabric_coords(
                [g[0], gpuinfo.Gpu(**{**g[1].__dict__, "pci_bus_id": ""})])

    def test_cuda_uuid_format(self):
        cuda = stub_cuda([("0000:4C:00.0", bytes(range(16)))])
        assert gpuinfo.CudaDeviceIds(cuda).devices == [
            ("0000:4C:00.0", "GPU-00010203-0405-0607-0809-0a0b0c0d0e0f")]

    def test_nvml_identity_needs_no_cuda_driver(self):
        lib = stub_nvml([h100(0)])

        class NoCuda:
            def __getattr__(self, name):
                raise AssertionError(f"CUDA driver called: {name}")
        gpus = gpuinfo.NativeBackend(lib=lib, cuda_lib=NoCuda()).gpus()
        assert gpus[0].uuid == h100(0)["uuid"]

    def test_missing_library_raises(self, monkeypatch):
        def no_lib(name):
            raise OSError(f"{name}: cannot open shared object file")
        monkeypatch.setattr(gpuinfo.ctypes, "CDLL", no_lib)
        with pytest.raises(OSError, match="libnvidia-ml.so.1"):
            gpuinfo.NativeBackend()


CLUSTER = bytes.fromhex("0123456789abcdef0123456789abcdef")


class TestNvlinkClique:
    def test_nvlink_connected_gpus_share_one_clique(self):
        lib = stub_nvml([h100(i, links=[1] * 18) for i in range(4)])
        backend = gpuinfo.NativeBackend(lib=lib)
        gpus = backend.gpus()
        assert {g.clique_id for g in gpus} == {""}
        assert {g.slice_topology for g in gpus} == {"4x1x1"}
        assert [g.coords for g in gpus] == [(i, 0, 0) for i in range(4)]
        assert backend.fabric[0] == {"source": "nvlink", "active_links": 18}
        # The read stops past the last link (INVALID_ARGUMENT).
        assert lib.calls.count("nvmlDeviceGetNvLinkState") == 4 * 18

    @pytest.mark.parametrize("lone", [
        {"links": [0, 0, 0]}, {"links": NOT_SUPPORTED}],
        ids=["no-active-link", "nvlink-not-supported"])
    def test_gpu_without_nvlink_is_its_own_clique(self, lone):
        lib = stub_nvml([h100(0), h100(1, **lone), h100(2), h100(3)])
        backend = gpuinfo.NativeBackend(lib=lib)
        gpus = backend.gpus()
        assert gpus[1].clique_id == gpus[1].uuid
        assert gpus[1].slice_topology == "1x1x1"
        assert gpus[1].coords == (0, 0, 0)
        assert [g.slice_topology for g in gpus[::2]] == ["3x1x1"] * 2
        assert [gpus[i].coords for i in (0, 2, 3)] == [
            (0, 0, 0), (1, 0, 0), (2, 0, 0)]
        assert backend.fabric[1] == {"source": "none", "active_links": 0}

    def test_fabric_clique_id_read(self):
        fabric = (0, 0, gpuinfo.NVML_GPU_FABRIC_STATE_COMPLETED, 7, CLUSTER)
        lib = stub_nvml([h100(0, fabric=fabric), h100(1, fabric=fabric),
                         h100(2)])
        gpus = gpuinfo.NativeBackend(lib=lib).gpus()
        want = "01234567-89ab-cdef-0123-456789abcdef.7"
        assert [g.clique_id for g in gpus] == [want, want, ""]
        assert [g.slice_topology for g in gpus] == ["2x1x1", "2x1x1",
                                                    "1x1x1"]

    @pytest.mark.parametrize("fabric", [
        (0, 0, gpuinfo.NVML_GPU_FABRIC_STATE_COMPLETED, 0, bytes(16)),
        (0, 0, 1, 3, CLUSTER),           # registration not started
        (0, 999, gpuinfo.NVML_GPU_FABRIC_STATE_COMPLETED, 3, CLUSTER)],
        ids=["zero-cluster", "not-completed", "failed-status"])
    def test_incomplete_fabric_falls_back_to_nvlink(self, fabric):
        """A single node's fabric manager registers its GPUs with an
        all-zero cluster UUID (the H100 host's NVML does): no fabric id,
        the NVLink state decides."""
        lib = stub_nvml([h100(0, fabric=fabric), h100(1, fabric=fabric)])
        gpus = gpuinfo.NativeBackend(lib=lib).gpus()
        assert [g.clique_id for g in gpus] == ["", ""]
        assert {g.slice_topology for g in gpus} == {"2x1x1"}

    def test_optional_symbols_missing_read_as_not_supported(self):
        lib = stub_nvml([h100(0), h100(1)])
        for sym in gpuinfo.NVML_OPTIONAL_SYMBOLS:
            delattr(lib, sym)
        backend = gpuinfo.NativeBackend(lib=lib)
        assert sorted(backend.missing_symbols) == sorted(
            gpuinfo.NVML_OPTIONAL_SYMBOLS)
        gpus = backend.gpus()
        assert [g.slice_topology for g in gpus] == ["1x1x1", "1x1x1"]
        assert backend.health_registration() == {0: "not_supported",
                                                 1: "not_supported"}
        assert backend.wait_health_event(0.01) is None

    def test_a_required_symbol_missing_raises(self):
        lib = stub_nvml([h100(0)])
        del lib.nvmlDeviceGetUUID
        with pytest.raises(AttributeError):
            gpuinfo.NativeBackend(lib=lib)


class TestHealthEvents:
    def test_event_set_registered_for_xid_and_ecc(self):
        lib = stub_nvml([h100(0), h100(1), h100(2)],
                        register_rc={1: NOT_SUPPORTED})
        backend = gpuinfo.NativeBackend(lib=lib)
        assert backend.health_registration() == {
            0: "registered", 1: "not_supported", 2: "registered"}
        assert backend.health_unsupported == [1]
        assert lib.registered == {0: 0xA, 2: 0xA}
        # Made once.
        backend.wait_health_event(0.01)
        assert lib.calls.count("nvmlEventSetCreate") == 1
        backend.close()
        assert lib.calls[-2:] == ["nvmlEventSetFree", "nvmlShutdown"]

    def test_events_map_to_their_gpu(self):
        lib = stub_nvml([h100(0), h100(1)], events=[
            (1, gpuinfo.NVML_EVENT_XID_CRITICAL, 79),
            (0, gpuinfo.NVML_EVENT_DOUBLE_BIT_ECC, 0),
            (None, gpuinfo.NVML_EVENT_XID_CRITICAL, 31)])
        backend = gpuinfo.NativeBackend(lib=lib)
        got = [backend.wait_health_event(0.5) for _ in range(4)]
        assert got == [
            gpuinfo.HealthEvent(1, "xid", 79, "critical XID 79"),
            gpuinfo.HealthEvent(0, "ecc_dbe", 48, "double-bit ECC error"),
            gpuinfo.HealthEvent(-1, "xid", 31, "critical XID 31"),
            None]

    def test_registration_error_raises(self):
        lib = stub_nvml([h100(0)], register_rc={0: 999})
        with pytest.raises(gpuinfo.NvmlError,
                           match="nvmlDeviceRegisterEvents"):
            gpuinfo.NativeBackend(lib=lib).wait_health_event(0.01)

    def test_fake_events_match_reference_fake(self):
        ref = tpuinfo.FakeBackend(tpuinfo.default_fake_chips(8, "v5e"))
        port = gpuinfo.FakeBackend()
        for idx, kind, code in ((3, "xid", 79), (-1, "info", 13),
                                (3, "recovered", 0), (5, "xid", 48)):
            ref.inject_health_event(tpuinfo.HealthEvent(idx, code, kind))
            port.inject_health_event(gpuinfo.HealthEvent(idx, kind, code))
        for _ in range(4):
            r, p = ref.wait_health_event(0.5), port.wait_health_event(0.5)
            assert (p.gpu_index, p.kind, p.code) == (r.chip_index, r.kind,
                                                     r.code)
        assert ref.wait_health_event(0.01) is None
        assert port.wait_health_event(0.01) is None
        assert [g.healthy for g in port.gpus()] == [
            c.healthy for c in ref.chips()]
        assert not port.get_gpu(5).healthy and port.get_gpu(3).healthy


class TestGetBackend:
    def test_fake_only_when_asked(self, monkeypatch):
        monkeypatch.setenv(gpuinfo.BACKEND_ENV, "fake")
        assert isinstance(gpuinfo.get_backend(), gpuinfo.FakeBackend)
        monkeypatch.delenv(gpuinfo.BACKEND_ENV)
        assert isinstance(gpuinfo.get_backend("fake"), gpuinfo.FakeBackend)

    def test_native_by_default(self, monkeypatch):
        monkeypatch.delenv(gpuinfo.BACKEND_ENV, raising=False)
        made = []

        class Native:
            def __init__(self):
                made.append(self)
        monkeypatch.setattr(gpuinfo, "NativeBackend", Native)
        assert gpuinfo.get_backend() is made[0]
        assert gpuinfo.get_backend("native") is made[1]

    def test_no_fallback_when_nvml_fails(self, monkeypatch):
        monkeypatch.delenv(gpuinfo.BACKEND_ENV, raising=False)

        def no_lib(name):
            raise OSError(f"{name}: cannot open shared object file")
        monkeypatch.setattr(gpuinfo.ctypes, "CDLL", no_lib)
        with pytest.raises(OSError):
            gpuinfo.get_backend()
        monkeypatch.setenv(gpuinfo.BACKEND_ENV, "native")
        with pytest.raises(OSError):
            gpuinfo.get_backend()

    def test_unknown_kind_refused(self):
        with pytest.raises(ValueError, match="unknown GPU info backend"):
            gpuinfo.get_backend("auto")
