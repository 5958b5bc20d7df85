"""Port parity: tpu_dra_torch.kubeletplugin.wire (a hand-written proto3
codec) against the reference's generated protobuf messages
(tpu_dra/kubeletplugin/gen/dra_v1_pb2.py, pluginregistration_pb2.py), on
the CPU.

Every message in both directions: the port's bytes parse with protobuf
into the message the port built, and protobuf's bytes parse with the
port. Messages without a map are byte-equal; a map's entries may come
in another order (protobuf writes its hash order), so those compare as
parsed messages. Exact comparisons: this is encoding, no arithmetic.
"""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_dra.kubeletplugin.gen import dra_v1_pb2 as dra
from tpu_dra.kubeletplugin.gen import pluginregistration_pb2 as reg
from tpu_dra_torch.kubeletplugin import wire

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

TEXT = st.text(max_size=12)


def ref_claims(msg, claims):
    for c in claims:
        out = msg.claims.add()
        out.namespace, out.uid, out.name = c.namespace, c.uid, c.name
    return msg


def port_claims(cls, claims):
    return cls(claims=[wire.Claim(namespace=c.namespace, uid=c.uid,
                                  name=c.name) for c in claims])


def claim_list(n, text=""):
    return [wire.Claim(namespace=f"ns{text}{i % 3}", uid=f"uid-{text}{i}",
                       name=f"claim-{i}{text}") for i in range(n)]


def ref_device(d):
    return dra.Device(request_names=d.request_names, pool_name=d.pool_name,
                      device_name=d.device_name,
                      cdi_device_ids=d.cdi_device_ids)


def ref_to_dict(msg):
    """A protobuf message as the same plain values as wire's to_dict."""
    out = {}
    for f in msg.DESCRIPTOR.fields:
        value = getattr(msg, f.name)
        if f.message_type is not None and f.message_type.GetOptions().map_entry:
            out[f.name] = {k: ref_to_dict(v) for k, v in value.items()}
        elif f.is_repeated:
            out[f.name] = [ref_to_dict(v) if f.message_type else v
                           for v in value]
        else:
            out[f.name] = value
    return out


CLAIM_CASES = {
    "empty": [],
    "one": claim_list(1),
    "unicode": [wire.Claim(namespace="nś-ü", uid="uïd-✓", name="クレーム"),
                wire.Claim(uid="only-uid")],
    "many": claim_list(64),
}


@pytest.mark.parametrize("case", sorted(CLAIM_CASES))
@pytest.mark.parametrize("kind", ["prepare", "unprepare"])
class TestRequests:
    def _pair(self, kind, claims):
        if kind == "prepare":
            return (port_claims(wire.NodePrepareResourcesRequest, claims),
                    ref_claims(dra.NodePrepareResourcesRequest(), claims))
        return (port_claims(wire.NodeUnprepareResourcesRequest, claims),
                ref_claims(dra.NodeUnprepareResourcesRequest(), claims))

    def test_bytes_equal_and_parse_both_ways(self, kind, case):
        port, ref = self._pair(kind, CLAIM_CASES[case])
        port_bytes = port.SerializeToString()
        assert port_bytes == ref.SerializeToString()
        assert type(ref).FromString(port_bytes) == ref
        assert type(port).FromString(ref.SerializeToString()) == port
        assert port.to_dict() == ref_to_dict(ref)


def prepare_responses():
    dev = wire.Device(request_names=["gpu", "r2"], pool_name="node-a",
                      device_name="gpu-3",
                      cdi_device_ids=["k8s.gpu.dev/gpu=GPU-x",
                                      "k8s.gpu.dev/claim=u1"])
    return {
        "empty": {},
        "success": {"u1": wire.NodePrepareResourceResponse(devices=[dev])},
        "no-devices": {"u1": wire.NodePrepareResourceResponse()},
        "error-and-success": {
            "u1": wire.NodePrepareResourceResponse(devices=[dev, dev]),
            "ü-2": wire.NodePrepareResourceResponse(error="not found ✗")},
        "many": {f"uid-{i}": wire.NodePrepareResourceResponse(
            devices=[wire.Device(pool_name="p", device_name=f"gpu-{i % 8}")])
            for i in range(64)},
    }


class TestPrepareResponse:
    @pytest.mark.parametrize("case", sorted(prepare_responses()))
    def test_parse_both_ways(self, case):
        claims = prepare_responses()[case]
        port = wire.NodePrepareResourcesResponse(claims=claims)
        ref = dra.NodePrepareResourcesResponse()
        for uid, res in claims.items():
            out = ref.claims[uid]
            if res.error:
                out.error = res.error
            for d in res.devices:
                out.devices.append(ref_device(d))
        assert dra.NodePrepareResourcesResponse.FromString(
            port.SerializeToString()) == ref
        assert wire.NodePrepareResourcesResponse.FromString(
            ref.SerializeToString()) == port
        assert port.to_dict() == ref_to_dict(ref)
        # One entry alone has one order: byte-equal.
        if len(claims) <= 1:
            assert port.SerializeToString() == ref.SerializeToString()

    def test_device_bytes_equal(self):
        d = prepare_responses()["success"]["u1"].devices[0]
        assert d.SerializeToString() == ref_device(d).SerializeToString()
        inner = wire.NodePrepareResourceResponse(devices=[d], error="e")
        ref = dra.NodePrepareResourceResponse(devices=[ref_device(d)],
                                              error="e")
        assert inner.SerializeToString() == ref.SerializeToString()


class TestUnprepareResponse:
    @pytest.mark.parametrize("errors", [{}, {"u1": ""}, {"u1": "busy"},
                                        {"a": "", "b": "x", "ç": ""}],
                             ids=["empty", "success", "error", "mixed"])
    def test_parse_both_ways(self, errors):
        port = wire.NodeUnprepareResourcesResponse(claims={
            uid: wire.NodeUnprepareResourceResponse(error=err)
            for uid, err in errors.items()})
        ref = dra.NodeUnprepareResourcesResponse()
        for uid, err in errors.items():
            if err:
                ref.claims[uid].error = err
            else:
                ref.claims[uid].SetInParent()
        assert dra.NodeUnprepareResourcesResponse.FromString(
            port.SerializeToString()) == ref
        assert wire.NodeUnprepareResourcesResponse.FromString(
            ref.SerializeToString()) == port
        if len(errors) <= 1:
            assert port.SerializeToString() == ref.SerializeToString()


class TestRegistration:
    @pytest.mark.parametrize("fields", [
        {}, {"type": "DRAPlugin", "name": "gpu.dev",
             "endpoint": "/var/lib/kubelet/plugins/gpu.dev/dra.sock",
             "supported_versions": ["v1", "v1beta1"]},
        {"name": "ünï"}], ids=["empty", "full", "unicode"])
    def test_plugin_info(self, fields):
        port, ref = wire.PluginInfo(**fields), reg.PluginInfo(**fields)
        assert port.SerializeToString() == ref.SerializeToString()
        assert wire.PluginInfo.FromString(ref.SerializeToString()) == port
        assert reg.PluginInfo.FromString(port.SerializeToString()) == ref

    @pytest.mark.parametrize("registered,error", [
        (False, ""), (True, ""), (False, "version v2 unsupported")])
    def test_registration_status(self, registered, error):
        port = wire.RegistrationStatus(plugin_registered=registered,
                                       error=error)
        ref = reg.RegistrationStatus(plugin_registered=registered,
                                     error=error)
        assert port.SerializeToString() == ref.SerializeToString()
        assert wire.RegistrationStatus.FromString(
            ref.SerializeToString()) == port
        assert reg.RegistrationStatus.FromString(
            port.SerializeToString()) == ref

    @pytest.mark.parametrize("port_cls,ref_cls", [
        (wire.InfoRequest, reg.InfoRequest),
        (wire.RegistrationStatusResponse, reg.RegistrationStatusResponse)])
    def test_empty_messages(self, port_cls, ref_cls):
        assert port_cls().SerializeToString() == b"" \
            == ref_cls().SerializeToString()
        assert port_cls.FromString(b"") == port_cls()


class TestDecoding:
    def test_unknown_fields_skipped(self):
        """A newer kubelet's fields (every wire type) are skipped, as
        protobuf skips them."""
        known = wire.Claim(namespace="n", uid="u", name="c")
        extra = (b"\x20\x07"                        # field 4, varint
                 b"\x29" + bytes(8) +               # field 5, fixed64
                 b"\x32\x02hi"                      # field 6, bytes
                 b"\x3d" + bytes(4))                # field 7, fixed32
        data = known.SerializeToString() + extra
        assert wire.Claim.FromString(data) == known
        assert dra.Claim.FromString(data).uid == "u"

    def test_last_map_entry_wins(self):
        e1 = wire.NodeUnprepareResourcesResponse(
            claims={"u": wire.NodeUnprepareResourceResponse(error="a")})
        e2 = wire.NodeUnprepareResourcesResponse(
            claims={"u": wire.NodeUnprepareResourceResponse(error="b")})
        data = e1.SerializeToString() + e2.SerializeToString()
        assert wire.NodeUnprepareResourcesResponse.FromString(
            data).claims["u"].error == "b"
        assert dra.NodeUnprepareResourcesResponse.FromString(
            data).claims["u"].error == "b"

    @pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x0a", b"\x08",
                                      b"\x0a\x02\xff\xfe", b"\x0b"],
                             ids=["short-len", "no-len", "no-varint",
                                  "bad-utf8", "group"])
    def test_malformed_refused(self, data):
        with pytest.raises(wire.WireError):
            wire.NodePrepareResourcesRequest.FromString(data)
        with pytest.raises(Exception):
            dra.NodePrepareResourcesRequest.FromString(data)

    def test_wrong_wire_type_refused(self):
        with pytest.raises(wire.WireError, match="wire type"):
            wire.Claim.FromString(b"\x10\x01")   # uid as a varint


CLAIMS = st.lists(st.builds(wire.Claim, namespace=TEXT, uid=TEXT,
                            name=TEXT), max_size=20)


@settings(max_examples=60, deadline=None)
@given(claims=CLAIMS)
def test_random_claim_lists_round_trip_with_protobuf(claims):
    port = port_claims(wire.NodePrepareResourcesRequest, claims)
    ref = ref_claims(dra.NodePrepareResourcesRequest(), claims)
    assert port.SerializeToString() == ref.SerializeToString()
    assert wire.NodePrepareResourcesRequest.FromString(
        ref.SerializeToString()) == port


@settings(max_examples=40, deadline=None)
@given(entries=st.dictionaries(TEXT, st.tuples(
    TEXT, st.lists(st.tuples(TEXT, TEXT, st.lists(TEXT, max_size=3)),
                   max_size=3)), max_size=8))
def test_random_prepare_responses_parse_both_ways(entries):
    port = wire.NodePrepareResourcesResponse()
    ref = dra.NodePrepareResourcesResponse()
    for uid, (error, devices) in entries.items():
        devs = [wire.Device(pool_name=p, device_name=n, cdi_device_ids=ids,
                            request_names=["gpu"]) for p, n, ids in devices]
        port.claims[uid] = wire.NodePrepareResourceResponse(devices=devs,
                                                            error=error)
        out = ref.claims[uid]
        out.error = error
        for d in devs:
            out.devices.append(ref_device(d))
    assert dra.NodePrepareResourcesResponse.FromString(
        port.SerializeToString()) == ref
    assert wire.NodePrepareResourcesResponse.FromString(
        ref.SerializeToString()) == port
