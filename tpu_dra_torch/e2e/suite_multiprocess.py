"""Multiprocess sharing (tests/e2e/test_multiprocess.sh): the MPS
claim's control daemon comes up as a Deployment on the claim's node, its
readiness gates the prepare, both tenant containers reach Succeeded
having seen the shared limits and reached the live daemon over its
pipe, and unprepare reclaims the Deployment.

The demo runs on a simulated node, whose MPS daemon is
testing.MPS_STANDIN: on a card node the card refuses the exclusive
compute mode MPS needs."""

from __future__ import annotations

from typing import Dict

from tpu_dra_torch.deploy import demos
from tpu_dra_torch.e2e.helpers import E2E, check

TENANT = ["python", "-c",
          "import json, os, subprocess, sys\n"
          "out = subprocess.run([sys.executable, '-m', "
          "'tpu_dra_torch.testing'], input='get_server_list\\n', "
          "capture_output=True, text=True)\n"
          "print(json.dumps({'daemon_rc': out.returncode, "
          "'threads': os.environ.get('CUDA_MPS_ACTIVE_THREAD_PERCENTAGE'), "
          "'pipe': os.environ.get('CUDA_MPS_PIPE_DIRECTORY'), "
          "'visible': os.environ.get('CUDA_VISIBLE_DEVICES')}))"]


def run(e2e: E2E) -> Dict:
    docs = demos.test_mps_shared_gpu(TENANT)
    ns = docs[0]["metadata"]["name"]
    docs[-1]["spec"]["nodeName"] = e2e.fake_node
    e2e.apply(docs)
    e2e.wait_until(180, "multiprocess pods Succeeded",
                   lambda: e2e.all_pods_phase(ns, "Succeeded"))
    p = e2e.pod(ns, "pod0")
    (r,) = e2e.results(e2e.claim_of(p, "gpu"))
    uuid = e2e.device_attr(r["pool"], r["device"], "uuid")
    tenants = {}
    for c in ("ctr0", "ctr1"):
        t = e2e.last_json(ns, "pod0", c)
        check(t["daemon_rc"] == 0,
              f"tenant {c} never reached the MPS control daemon: {t}")
        check(t["threads"] == "50",
              f"tenant {c} did not see the shared limits: {t}")
        check(t["visible"] == uuid, f"tenant {c} sees {t['visible']}")
        tenants[c] = t
    check(tenants["ctr0"]["pipe"] == tenants["ctr1"]["pipe"],
          f"the tenants' pipes differ: {tenants}")
    e2e.delete_docs(reversed(docs[1:]))
    e2e.wait_until(120, "MPS control daemon Deployment reclaimed",
                   lambda: not e2e.mps_deployments())
    return {"node": r["pool"], "device": r["device"]}
