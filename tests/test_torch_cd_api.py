"""The port's compute-domain kinds, CRD and domain_topology against the
reference's (tpu_dra.api.types/scheme/crd, tpu_dra.topology.placement).

The same documents go through both packages, the reference's side with
its names, the port's after the name map below (CD_NAME_MAP, applied to
the reference's JSON): decoding (strict and not), normalize, validate and
to_dict must agree exactly — a document one side refuses the other
refuses at the same stage. This file holds the map for every
test_torch_cd* file.
"""

import json

import pytest

from tpu_dra.api import crd as ref_crd
from tpu_dra.api import scheme as ref_scheme
from tpu_dra.api import types as ref_types
from tpu_dra.topology import placement as ref_placement
from tpu_dra_torch.api import crd as port_crd
from tpu_dra_torch.api import scheme as port_scheme
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.topology import placement as port_placement

# Reference name -> port name, in order (longer names first where one is
# a prefix of another). Keys and values of envs, objects and manifests.
CD_NAME_MAP = (
    ("compute-domain-default-channel.tpu.dev",
     "compute-domain-default-channel.gpu.dev"),
    ("compute-domain-daemon.tpu.dev", "compute-domain-daemon.gpu.dev"),
    ("k8s.compute-domain.tpu.dev", "k8s.compute-domain.gpu.dev"),
    ("compute-domain.tpu.dev", "compute-domain.gpu.dev"),
    ("resource.tpu.dev", "resource.gpu.dev"),
    ("tpu_dra.cddaemon", "tpu_dra_torch.cddaemon"),
    ("tpu-cd-daemon", "gpu-cd-daemon"),
    ("tpu-dra-driver", "gpu-dra-driver"),
    ("slice-daemon", "domain-daemon"),
    ("MAX_NODES_PER_SLICE_DOMAIN", "MAX_NODES_PER_CLIQUE_DOMAIN"),
    ("MEGASCALE_COORDINATOR_ADDRESS", "GPU_CLIQUES_COORDINATOR_ADDRESS"),
    ("MEGASCALE_NUM_SLICES", "GPU_NUM_CLIQUES"),
    ("MEGASCALE_SLICE_ID", "GPU_CLIQUE_INDEX"),
    ("TPU_CD_SLICE_ALIGNED", "GPU_CD_CLIQUE_ALIGNED"),
    ("TPU_CD_SLICES", "GPU_CD_CLIQUES"),
    ("TPU_CD_CHANNELS", "GPU_CD_CHANNELS"),
    ("TPU_SLICE_ID", "GPU_CLIQUE_ID"),
    ("TPU_WORKER_ID", "GPU_WORKER_ID"),
    ("TPU_WORKER_HOSTNAMES", "GPU_WORKER_HOSTNAMES"),
    ("TPU_PROCESS_COUNT", "GPU_PROCESS_COUNT"),
    ("TPU_COORDINATOR_ADDRESS", "GPU_COORDINATOR_ADDRESS"),
    ("sliceAligned", "cliqueAligned"),
    ('"slices"', '"cliques"'),
    ("sliceID", "cliqueID"),
)
# The torch.distributed rendezvous the port's channel env adds.
PORT_ONLY_ENV = ("MASTER_ADDR", "MASTER_PORT", "NODE_RANK", "NNODES")


def cd_to_port(obj):
    """The reference's object with its names mapped to the port's."""
    text = json.dumps(obj, sort_keys=True)
    for ref, port in CD_NAME_MAP:
        text = text.replace(ref, port)
    return json.loads(text)


def _outcome(scheme, types, doc, strict):
    """("decode", None) | ("invalid", None) | ("ok", to_dict())."""
    dec = scheme.StrictDecoder if strict else scheme.NonstrictDecoder
    try:
        obj = dec.decode(doc)
    except scheme.DecodeError:
        return ("decode", None)
    obj.normalize()
    try:
        obj.validate()
    except types.ValidationError:
        return ("invalid", None)
    return ("ok", obj.to_dict())


API = "resource.tpu.dev/v1beta1"


def _cd(**over):
    doc = {"apiVersion": API, "kind": "ComputeDomain",
           "metadata": {"name": "cd", "namespace": "ns", "uid": "u1"},
           "spec": {"numNodes": 2, "channel": {
               "resourceClaimTemplate": {"name": "rct"},
               "allocationMode": "Single"}},
           "status": {"status": "Ready", "nodes": [
               {"name": "n0", "ipAddress": "10.0.0.1", "sliceID": "s0",
                "index": 0, "status": "Ready"},
               {"name": "n1", "ipAddress": "10.0.0.2", "sliceID": "s0",
                "index": 1, "status": "NotReady"}]}}
    for path, value in over.items():
        *head, last = path.split("__")
        cur = doc
        for k in head:
            cur = cur[k]
        if value is _DROP:
            cur.pop(last)
        else:
            cur[last] = value
    return doc


_DROP = object()

DOCS = {
    "channel": {"apiVersion": API, "kind": "ComputeDomainChannelConfig",
                "domainID": "u1", "allocationMode": "Single"},
    "channel_all": {"apiVersion": API, "kind": "ComputeDomainChannelConfig",
                    "domainID": "u1", "allocationMode": "All"},
    "channel_mode_defaulted": {"apiVersion": API,
                               "kind": "ComputeDomainChannelConfig",
                               "domainID": "u1", "allocationMode": ""},
    "channel_no_domain": {"apiVersion": API,
                          "kind": "ComputeDomainChannelConfig"},
    "channel_bad_mode": {"apiVersion": API,
                         "kind": "ComputeDomainChannelConfig",
                         "domainID": "u1", "allocationMode": "Some"},
    "channel_unknown_field": {"apiVersion": API,
                              "kind": "ComputeDomainChannelConfig",
                              "domainID": "u1", "extra": 1},
    "daemon": {"apiVersion": API, "kind": "ComputeDomainDaemonConfig",
               "domainID": "u1"},
    "daemon_no_domain": {"apiVersion": API,
                         "kind": "ComputeDomainDaemonConfig"},
    "cd": _cd(),
    "cd_mode_defaulted": _cd(spec__channel__allocationMode=""),
    "cd_no_channel": _cd(spec__channel=_DROP),
    "cd_negative_nodes": _cd(spec__numNodes=-1),
    "cd_no_rct_name": _cd(spec__channel__resourceClaimTemplate={}),
    "cd_bad_mode": _cd(spec__channel__allocationMode="Every"),
    "cd_nodes_not_a_list": _cd(status__nodes={"n0": {}}),
    "cd_node_unknown_field": _cd(status__nodes=[
        {"name": "n0", "sliceID": "s0", "index": 0, "rack": "r1"}]),
    "cd_wrong_version": dict(_cd(), apiVersion="resource.tpu.dev/v1"),
}


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_kinds_decode_validate_and_round_trip_like_reference(name, strict):
    """Each document through the reference's (StrictDecoder or
    NonstrictDecoder, normalize, validate, to_dict) and the port's after
    the name map: the same outcome, and equal to_dict (exact, mapped)."""
    doc = DOCS[name]
    ref = _outcome(ref_scheme, ref_types, doc, strict)
    port = _outcome(port_scheme, port_types, cd_to_port(doc), strict)
    assert port[0] == ref[0], (ref, port)
    assert port[1] == cd_to_port(ref[1])


def test_constants_map_to_the_reference():
    names = ("COMPUTE_DOMAIN_DRIVER_NAME", "COMPUTE_DOMAIN_LABEL_KEY",
             "COMPUTE_DOMAIN_FINALIZER", "DEVICE_CLASS_DAEMON",
             "DEVICE_CLASS_CHANNEL", "COMPUTE_DOMAIN_KIND",
             "COMPUTE_DOMAIN_CHANNEL_CONFIG_KIND",
             "COMPUTE_DOMAIN_DAEMON_CONFIG_KIND",
             "COMPUTE_DOMAIN_STATUS_READY", "COMPUTE_DOMAIN_STATUS_NOT_READY",
             "COMPUTE_DOMAIN_STATUS_DEGRADED", "ALLOCATION_MODE_SINGLE",
             "ALLOCATION_MODE_ALL")
    assert {n: getattr(port_types, n) for n in names} == cd_to_port(
        {n: getattr(ref_types, n) for n in names})
    assert port_types.COMPUTE_DOMAIN_DRIVER_NAME == "compute-domain.gpu.dev"


def test_node_dataclass_fields():
    node = port_types.ComputeDomainNode.from_dict(
        {"name": "n", "ipAddress": "1.2.3.4", "cliqueID": "c.1",
         "index": 3, "status": "Ready"}, True, "n")
    assert (node.clique_id, node.index) == ("c.1", 3)
    assert port_types.ComputeDomain.from_dict(
        cd_to_port(_cd())).uid == "u1"


def test_crd_manifest_matches_reference():
    assert port_crd.compute_domain_crd() == cd_to_port(
        ref_crd.compute_domain_crd())


# Member sets whose every member is in a clique: domain_topology agrees
# with the reference's exactly (after the name map).
MEMBERS = {
    "one_member": [{"sliceID": "a", "index": 0}],
    "contiguous": [{"sliceID": "a", "index": i} for i in (2, 0, 1)],
    "gap": [{"sliceID": "a", "index": i} for i in (0, 2)],
    "offset": [{"sliceID": "a", "index": i} for i in (3, 4)],
    "two_cliques": [{"sliceID": "a", "index": 0},
                    {"sliceID": "b", "index": 0}],
    "three_cliques": [{"sliceID": s, "index": 0} for s in "abc"],
}


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_domain_topology_matches_reference(name):
    members = MEMBERS[name]
    assert port_placement.domain_topology(cd_to_port(members)) == \
        cd_to_port(ref_placement.domain_topology(members))


@pytest.mark.parametrize("members,want", [
    ([{"cliqueID": "", "index": 0}, {"cliqueID": "", "index": 1}],
     {"cliques": 0, "cliqueAligned": False}),
    ([{"cliqueID": "a", "index": 0}, {"cliqueID": "", "index": 0}],
     {"cliques": 1, "cliqueAligned": False}),
    ([], {"cliques": 0, "cliqueAligned": False}),
])
def test_domain_topology_members_without_clique_are_in_none(members, want):
    """Where the port departs from the reference on purpose: an empty
    cliqueID is a member without a multi-node NVLink domain, so it
    counts in no clique and the domain is not aligned (the reference
    counts its empty slice id as one aligned slice: two HGX nodes without
    a fabric manager would read as one NVLink domain)."""
    assert port_placement.domain_topology(members) == want
    ref = ref_placement.domain_topology(
        [{"sliceID": m["cliqueID"], "index": m["index"]} for m in members])
    if members and all(not m["cliqueID"] for m in members):
        assert ref == {"slices": 1, "sliceAligned": True}
