"""The domain daemon under ThreadSanitizer, driven with hostile
concurrency (the port's counterpart of the slice-daemon half of
hack/tsan_drive.py).

    python -m tpu_dra_torch.race.tsan_drive

The port's only threaded native code is tpu_dra_torch/native/src/
domain_daemon.cc: a server thread answering ``Q`` and ``H`` and a sweep
thread saying ``H`` to every peer of the nodes config, sharing one
mutex. The drive builds the TSan flavour (``binary.build(tsan=True)``)
and makes both threads work at once:

- two daemons, each listing the other and one closed localhost port in
  its nodes config, so the sweep thread's hellos really run (one peer
  answers, one refuses);
- an idle client held open on each daemon (it ties up the serve loop
  for its read timeout);
- ``rounds`` rounds of ``probes`` concurrent ``--check --port`` probes
  per daemon; between rounds the nodes config is rewritten and both
  daemons get SIGUSR1, so reloads race the sweep;
- then SIGTERM to each.

Every process runs with ``TSAN_OPTIONS="halt_on_error=1 exitcode=66"``:
a report ends it with exit code 66. The drive fails on any such exit,
printing the report; on a daemon that does not exit 0; if no
probe ever read READY (a daemon that never started would otherwise pass
vacuously); and if no ``Q`` reply ever counted the live peer
(``READY peers=<n>/<total>`` with n >= 1), since then the hello path
never ran.

The reference's drive also hammers its native multiprocess coordinator;
the port has none (its MPS control daemon is NVIDIA's
nvidia-cuda-mps-control, which the plugin starts and does not build), so
that half has no counterpart here.
"""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from tpu_dra_torch.cddaemon import binary

TSAN_OPTIONS = "halt_on_error=1 exitcode=66"
TSAN_EXIT = 66
ROUNDS = 3
PROBES = 10
_PEERS = re.compile(r"^READY peers=(\d+)/(\d+)")


def tsan_env() -> Dict[str, str]:
    return {**os.environ, "TSAN_OPTIONS": TSAN_OPTIONS}


def verdict(returncode: int, stderr: str) -> Optional[str]:
    """The drive's reading of one process's exit: the report (its first
    3000 characters) when ThreadSanitizer reported (exit code 66), else
    None."""
    if returncode != TSAN_EXIT:
        return None
    text = stderr or ""
    start = max(text.find("WARNING: ThreadSanitizer"), 0)
    return text[start:start + 3000] or "exit code 66, stderr empty"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_peers(path: str, peers: List[str]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write("".join(f"{p}\n" for p in peers))
    os.replace(tmp, path)


def _stop(proc: subprocess.Popen) -> str:
    """SIGTERM, then the process's stderr (killed if it hangs)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        _, err = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    return err or ""


def drive(rounds: int = ROUNDS, probes: int = PROBES,
          path: Optional[str] = None) -> Dict:
    """Run the drive over the TSan daemon at `path` (default: built from
    the checkout's source); returns its record, ``ok`` the verdict and
    ``errors`` every reason it failed."""
    t0 = time.perf_counter()
    path = path or binary.build(tsan=True)
    env = tsan_env()
    ports = [_free_port(), _free_port()]
    closed = _free_port()
    errors: List[str] = []
    reports: List[str] = []
    ready = peers_seen = n_probes = 0
    daemons: List[subprocess.Popen] = []
    idle: List[socket.socket] = []
    rcs: List[Optional[int]] = []
    with tempfile.TemporaryDirectory(prefix="race-") as tmp:
        nodes_cfgs = []
        try:
            for i, port in enumerate(ports):
                nodes_cfg = os.path.join(tmp, f"nodes-{i}.cfg")
                _write_peers(nodes_cfg, [f"127.0.0.1:{ports[1 - i]}",
                                         f"127.0.0.1:{closed}"])
                nodes_cfgs.append(nodes_cfg)
                cfg = os.path.join(tmp, f"daemon-{i}.cfg")
                with open(cfg, "w") as f:
                    f.write(f"node_ip=127.0.0.1\nport={port}\n"
                            f"nodes_config={nodes_cfg}\nclique_id=race\n"
                            f"worker_index={i}\n")
                daemons.append(subprocess.Popen(
                    [path, "--config", cfg], env=env, text=True,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
            deadline = time.monotonic() + 30
            for port in ports:
                while True:
                    try:
                        idle.append(socket.create_connection(
                            ("127.0.0.1", port), timeout=1))
                        break
                    except OSError:
                        if time.monotonic() > deadline:
                            raise RuntimeError(
                                f"daemon on port {port} never listened")
                        time.sleep(0.05)

            def probe_all(n: int) -> None:
                nonlocal ready, peers_seen, n_probes
                checks = [subprocess.Popen(
                    [path, "--check", "--port", str(port)], env=env,
                    text=True, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE)
                    for port in ports for _ in range(n)]
                for c in checks:
                    out, err = c.communicate(timeout=60)
                    n_probes += 1
                    report = verdict(c.returncode, err)
                    if report:
                        reports.append(f"--check probe: {report}")
                    elif c.returncode == 0:
                        ready += 1
                        m = _PEERS.match(out)
                        if m:
                            peers_seen = max(peers_seen, int(m.group(1)))

            for r in range(rounds):
                probe_all(probes)
                # Membership change: reorder (and on odd rounds drop the
                # closed port), then reload both daemons while their
                # sweeps run.
                for i, nodes_cfg in enumerate(nodes_cfgs):
                    peers = [f"127.0.0.1:{closed}",
                             f"127.0.0.1:{ports[1 - i]}"]
                    _write_peers(nodes_cfg, peers[r % 2:])
                for d in daemons:
                    d.send_signal(signal.SIGUSR1)
                time.sleep(0.2)
            # A slow host may finish every round before a sweep lands:
            # probe on until a reply counts the live peer (every config
            # lists it), while both daemons live, for at most 10 s.
            deadline = time.monotonic() + 10
            while (peers_seen == 0 and time.monotonic() < deadline
                   and all(d.poll() is None for d in daemons)):
                probe_all(1)
                time.sleep(0.2)
        except Exception as e:  # noqa: BLE001  # drflow: swallow-ok[the drive's failure is its verdict, recorded in errors]
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            for s in idle:
                s.close()
            for d in daemons:
                err = _stop(d)
                rcs.append(d.returncode)
                report = verdict(d.returncode, err)
                if report:
                    reports.append(f"daemon: {report}")
                elif d.returncode != 0:
                    errors.append(f"daemon exited {d.returncode}: "
                                  f"{err[-1500:]}")
    if reports:
        errors.append(f"{len(reports)} ThreadSanitizer report(s)")
    if ready == 0:
        errors.append("no probe ever read READY: no race coverage")
    if peers_seen == 0:
        errors.append("no Q reply counted the live peer: the sweep "
                      "thread's hello path never ran")
    return {"ok": not errors, "errors": errors, "reports": reports,
            "daemon_rcs": rcs, "probes": n_probes, "ready": ready,
            "peers_seen": peers_seen, "binary": os.path.basename(path),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    res = drive()
    for report in res["reports"]:
        print(report, file=sys.stderr)
    print(json.dumps({k: v for k, v in res.items() if k != "reports"}))
    print("tsan drive:", "clean" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
