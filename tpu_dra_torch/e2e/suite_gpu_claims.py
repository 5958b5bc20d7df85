"""GPU claims (tests/e2e/test_tpu_claims.sh): the demo ladder gpu-test1
to gpu-test6 (tpu_dra_torch.deploy.demos), each applied, run to the end,
checked and deleted in turn.

- gpu-test1: two pods, one exclusive GPU each, keyed by (pool, device);
  pod0 trains through ``bench claim-child`` (the e2e runner's
  train_command; on a card node it runs there, on the card);
- gpu-test2: one claim shared by two containers of one pod;
- gpu-test3: one time-sliced claim shared by two pods;
- gpu-test4: one claim of four GPUs;
- gpu-test5: MIG devices;
- gpu-test6: two containers, each CEL-pinned to its own MIG device of
  one GPU, and an unsatisfiable claim whose pod stays Pending.
"""

from __future__ import annotations

import math
from typing import Dict, List

from tpu_dra_torch.deploy import demos
from tpu_dra_torch.e2e.helpers import E2E, PRINT_ENV, SuiteFailure, check
from tpu_dra_torch.k8s.resources import RESOURCECLAIMS

# tests/e2e/test_tpu_claims.sh's deadline for every demo.
DEMO_TIMEOUT_S = 120.0
# A training pod on the card builds nothing (the kernels are built by
# then) but runs the flagship at full width.
CARD_TRAIN_TIMEOUT_S = 300.0


def _run_demo(e2e: E2E, docs: List[Dict], timeout: float = DEMO_TIMEOUT_S,
              pods: List[str] = ()) -> str:
    """Apply, wait until the pods named (every pod of the namespace when
    none is named) have Succeeded; returns the namespace."""
    ns = docs[0]["metadata"]["name"]
    e2e.apply(docs)
    if pods:
        for name in pods:
            e2e.wait_until(timeout, f"{ns} {name} Succeeded",
                           lambda n=name: _ended(e2e, ns, n))
    else:
        e2e.wait_until(timeout, f"{ns} pods Succeeded",
                       lambda: _all_ended(e2e, ns))
    return ns


def _ended(e2e: E2E, ns: str, name: str) -> bool:
    phase = e2e.pod_phase(ns, name)
    if phase == "Failed":
        p = e2e.pod(ns, name)
        tail = "\n".join(e2e.cluster.pod_log(p, c["name"])[-2000:]
                         for c in p["spec"]["containers"])
        raise SuiteFailure(f"{ns}/{name} Failed:\n{tail}")
    return phase == "Succeeded"


def _all_ended(e2e: E2E, ns: str) -> bool:
    pods = e2e.pods(ns)
    return bool(pods) and all(_ended(e2e, ns, p["metadata"]["name"])
                              for p in pods)


def _finish(e2e: E2E, docs: List[Dict]) -> None:
    ns = docs[0]["metadata"]["name"]
    e2e.delete_docs(reversed(docs[1:]))
    e2e.wait_until(90, f"{ns} pods deleted", lambda: not e2e.pods(ns))


def _uuid(e2e: E2E, result: Dict) -> str:
    return e2e.device_attr(result["pool"], result["device"], "uuid")


def _pin(doc: Dict, node: str) -> Dict:
    doc["spec"]["nodeName"] = node
    return doc


def _train_pod(e2e: E2E, doc: Dict) -> Dict:
    ctr = doc["spec"]["containers"][0]
    ctr["command"] = list(e2e.train_command)
    if not e2e.card_node:
        # Two CPU tenants of one host spin against each other otherwise.
        ctr["env"] = [{"name": "OMP_NUM_THREADS", "value": "1"}]
    return doc


def test1(e2e: E2E) -> Dict:
    docs = demos.test1_exclusive_per_pod(PRINT_ENV)
    _train_pod(e2e, docs[2])
    if e2e.card_node:
        # The card is n0's one GPU: pod0 trains there, pod1 goes to the
        # simulated node (else it could take the card first).
        _pin(docs[2], "n0")
        _pin(docs[3], e2e.fake_node)
    ns = _run_demo(e2e, docs, CARD_TRAIN_TIMEOUT_S if e2e.card_node
                   else DEMO_TIMEOUT_S)
    keys = set()
    for p in e2e.pods(ns):
        (r,) = e2e.results(e2e.claim_of(p, "gpu"))
        check(r["pool"] == p["spec"]["nodeName"],
              f"{p['metadata']['name']}: claim on {r['pool']}, pod on "
              f"{p['spec']['nodeName']}")
        keys.add((r["pool"], r["device"]))
        if p["metadata"]["name"] == "pod1":
            env = e2e.last_json(ns, "pod1")
            check(env["CUDA_VISIBLE_DEVICES"] == _uuid(e2e, r),
                  f"pod1 sees {env['CUDA_VISIBLE_DEVICES']}, its claim "
                  f"holds {_uuid(e2e, r)}")
        else:
            train = e2e.last_json(ns, "pod0")
            check(train["claim_uuids"] == [_uuid(e2e, r)],
                  f"pod0 trained on {train['claim_uuids']}")
            check(train["steps"] >= 1 and all(
                math.isfinite(x) for x in train["losses"]),
                f"pod0's losses {train['losses']}")
            pool0 = r["pool"]
    check(len(keys) == 2, f"exclusive claims got one GPU: {keys}")
    _finish(e2e, docs)
    return {"train": {**train, "node": pool0}}


def test2(e2e: E2E) -> None:
    docs = demos.test2_shared_claim_two_containers(PRINT_ENV)
    ns = _run_demo(e2e, docs)
    p = e2e.pod(ns, "pod0")
    (r,) = e2e.results(e2e.claim_of(p, "gpu"))
    seen = [e2e.last_json(ns, "pod0", c)["CUDA_VISIBLE_DEVICES"]
            for c in ("ctr0", "ctr1")]
    check(seen == [_uuid(e2e, r)] * 2,
          f"containers of one claim see {seen}, want {_uuid(e2e, r)}")
    _finish(e2e, docs)


def test3(e2e: E2E) -> None:
    docs = demos.test3_time_sliced_across_pods(PRINT_ENV)
    if e2e.card_node:
        # The card's time slice cannot be set from here (nvidia-smi
        # sets nothing on that host): the simulated node shows it.
        for d in docs[2:]:
            _pin(d, e2e.fake_node)
    ns = _run_demo(e2e, docs)
    seen = {e2e.last_json(ns, f"pod{i}")["CUDA_VISIBLE_DEVICES"]
            for i in range(2)}
    (r,) = e2e.results(e2e.claim_of(e2e.pod(ns, "pod0"), "gpu"))
    check(seen == {_uuid(e2e, r)},
          f"time-sliced pods see {seen}, the claim holds {_uuid(e2e, r)}")
    _finish(e2e, docs)


def test4(e2e: E2E) -> None:
    docs = demos.test4_multi_gpu(PRINT_ENV, count=4)
    ns = _run_demo(e2e, docs)
    p = e2e.pod(ns, "pod0")
    results = e2e.results(e2e.claim_of(p, "gpu"))
    seen = e2e.last_json(ns, "pod0")["CUDA_VISIBLE_DEVICES"].split(",")
    check(len(seen) == 4 and sorted(seen) == sorted(
        _uuid(e2e, r) for r in results),
        f"gpu-test4 sees {seen}, its claim holds {results}")
    _finish(e2e, docs)


def test5(e2e: E2E) -> None:
    docs = demos.test5_mig(PRINT_ENV)
    ns = _run_demo(e2e, docs)
    for p in e2e.pods(ns):
        (r,) = e2e.results(e2e.claim_of(p, "gpu"))
        check(r["device"].startswith(f"gpu-{e2e.mig_gpu}-mig-"),
              f"gpu-test5 claim on {r['device']}")
        env = e2e.last_json(ns, p["metadata"]["name"])
        check((env["CUDA_VISIBLE_DEVICES"] or "").startswith("MIG-"),
              f"gpu-test5 pod sees {env['CUDA_VISIBLE_DEVICES']}")
    _finish(e2e, docs)


def test6(e2e: E2E) -> None:
    docs = demos.test6_cel_selection(e2e.mig_gpu)
    ns = _run_demo(e2e, docs, pods=["pod0"])
    p = e2e.pod(ns, "pod0")
    seen, pools = [], set()
    for i, start in enumerate(demos.TEST6_STARTS):
        (r,) = e2e.results(e2e.claim_of(p, f"mig{i}"))
        pools.add(r["pool"])
        profile = demos.TEST6_PROFILE.replace(".", "")
        check(r["device"] == f"gpu-{e2e.mig_gpu}-mig-{profile}-{start}",
              f"mig{i} allocated {r['device']}")
        line = e2e.log(ns, "pod0", f"ctr{i}").strip().splitlines()[-1]
        tag, _, uuid = line.partition(" CUDA_VISIBLE_DEVICES=")
        check(tag == f"CTR{i}" and uuid.startswith("MIG-")
              and uuid.endswith(f"{start:012x}"),
              f"ctr{i} did not get the placementStart={start} device: "
              f"{line}")
        seen.append(uuid)
    check(len(pools) == 1, f"the two MIG devices span nodes {pools}")
    # One GPU: the MIG UUIDs carry their parent GPU's.
    check(len({u.split("-")[1] for u in seen}) == 1,
          f"CEL-selected MIG devices are on different GPUs: {seen}")
    phase = e2e.pod_phase(ns, "pod-unsatisfiable")
    check(phase in ("", "Pending"),
          f"the unsatisfiable CEL claim's pod is {phase}")
    never = e2e.get(RESOURCECLAIMS, "no-such-architecture", ns)
    check(not (never.get("status") or {}).get("allocation"),
          f"the unsatisfiable claim got an allocation: {never.get('status')}")
    _finish(e2e, docs)


def run(e2e: E2E) -> Dict:
    out = test1(e2e)
    for step in (test2, test3, test4, test5, test6):
        step(e2e)
    out["demos"] = ["gpu-test1", "gpu-test2", "gpu-test3", "gpu-test4",
                    "gpu-test5", "gpu-test6"]
    return out
