"""The port's race tier (tpu_dra_torch.race, counterpart of hack/race.sh
and hack/tsan_drive.py) on the CPU, at small sizes.

- the daemon's TSan flavour (cddaemon.binary.build(tsan=True)) is a file
  of its own beside the regular binary, whose flags (and so its name)
  stay as they were;
- one short round of the TSan drive over two daemons reads clean, with
  READY seen and the live peer counted;
- planted races: a ~20-line C++ program with an unsynchronised counter in
  two threads, built with the TSan flags, is judged a report (exit 66)
  by the drive's own verdict (so TSAN_OPTIONS reaches the children),
  its atomic twin is not; a daemon built without its Q-handler lock
  fails the drive;
- the session plugin in a pytest subprocess over a tmp test file (the
  repo's conftest beside it): a lock-order cycle among port-created
  locks and a planted view drift each exit 3 with the export listing
  them; a clean file exits 0 with only the port's witness installed,
  even where TPU_DRA_LOCK_WITNESS was set around the runner;
- the runner's steps at a small size: one witnessed run of one HA test,
  then --check-witness / --check-view-shadow with 0 unexplained;
- gencrd writes the chart's committed CRD file.
"""

import json
import os
import shutil
import subprocess
import tempfile
import textwrap
import threading
from pathlib import Path

import pytest

from tpu_dra_torch.cddaemon import binary
from tpu_dra_torch.deploy import gencrd
from tpu_dra_torch.race import runner, tsan_drive

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(shutil.which("c++") is None,
                                reason="no C++ compiler on PATH")

RACY = r"""
#include <cstdio>
#include <thread>
%(decl)s
void bump() { for (int i = 0; i < 100000; ++i) counter++; }
int main() {
  std::thread a(bump), b(bump);
  a.join();
  b.join();
  std::printf("%%d\n", (int)counter);
  return 0;
}
"""


def _tsan_build(src: str, out: Path) -> str:
    out.with_suffix(".cc").write_text(src)
    subprocess.run(["c++", *binary.TSAN_FLAGS, "-o", str(out),
                    str(out.with_suffix(".cc"))], check=True, timeout=300)
    return str(out)


def test_tsan_and_regular_daemon_paths_differ_and_both_build():
    regular, tsan = binary.binary_path(), binary.binary_path(tsan=True)
    assert regular != tsan and regular.parent == tsan.parent
    assert regular.name.startswith(f"{binary.BINARY}-")
    assert tsan.name.startswith(f"{binary.BINARY}-tsan-")
    assert binary.CXX_FLAGS == ("-std=c++17", "-O2", "-pthread")
    assert "-fsanitize=thread" in binary.TSAN_FLAGS
    assert binary.build() == str(regular)
    assert binary.build(tsan=True) == str(tsan)
    assert os.access(regular, os.X_OK) and os.access(tsan, os.X_OK)


def test_tsan_build_falls_back_past_a_cxx_without_the_runtime(
        tmp_path, monkeypatch):
    """The card's host sets CXX to a g++ wrapper that finds no TSan
    runtime: the build goes on to the next compiler on PATH."""
    broken = tmp_path / "g++"
    broken.write_text("#!/bin/sh\n"
                      "echo '/usr/bin/ld: cannot find -ltsan' >&2\n"
                      "exit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    monkeypatch.setattr(binary, "BUILD_DIR", tmp_path / "build")
    assert binary._compilers()[0] == str(broken)
    assert os.access(binary.build(tsan=True), os.X_OK)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="failed to build") as e:
        binary.build()
    assert "cannot find -ltsan" in str(e.value)


def test_short_drive_reads_clean():
    res = tsan_drive.drive(rounds=1, probes=4)
    assert res["ok"], res
    assert res["daemon_rcs"] == [0, 0] and not res["reports"]
    assert res["ready"] > 0 and res["peers_seen"] >= 1
    assert res["seconds"] < 20


@pytest.mark.parametrize("decl,raced", [
    ("long counter = 0;", True),
    ("#include <atomic>\nstd::atomic<long> counter{0};", False),
])
def test_planted_counter_race_is_judged_a_report(tmp_path, decl, raced):
    path = _tsan_build(RACY % {"decl": decl}, tmp_path / "counter")
    proc = subprocess.run([path], env=tsan_drive.tsan_env(),
                          capture_output=True, text=True, timeout=60)
    report = tsan_drive.verdict(proc.returncode, proc.stderr)
    if raced:
        assert proc.returncode == tsan_drive.TSAN_EXIT
        assert report and "data race" in report
    else:
        assert proc.returncode == 0 and report is None


def test_daemon_without_its_lock_fails_the_drive(tmp_path):
    src = binary.SOURCE.read_text()
    guarded = ("    if (!req.empty() && req[0] == 'Q') {\n"
               "      std::lock_guard<std::mutex> l(mu_);\n")
    assert guarded in src
    racy = src.replace(guarded, "    if (!req.empty() && req[0] == 'Q') {\n")
    path = _tsan_build(racy, tmp_path / "daemon-racy")
    res = tsan_drive.drive(rounds=1, probes=4, path=path)
    assert not res["ok"]
    assert res["reports"] and tsan_drive.TSAN_EXIT in res["daemon_rcs"]
    assert any("data race" in r for r in res["reports"])


@pytest.fixture
def witness():
    """A private, installed port witness (the process-global graph is left
    to whatever session or harness uses it)."""
    from tpu_dra_torch.infra import lockwitness as lw

    w = lw.LockWitness()
    saved = lw.WITNESS
    lw.WITNESS = w
    lw.install(reset=False)
    yield w
    lw.uninstall()
    lw.WITNESS = saved


def _port_frame(src: str, **names):
    """Run `src` as if it were a tpu_dra_torch module (the witness keys
    locks by their creation frame); returns its namespace."""
    ns = dict(names)
    exec(compile(src, "/x/tpu_dra_torch/handoff.py", "exec"), ns)
    return ns


def _run_threads(*fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()


def test_lock_released_by_another_thread_ends_its_acquirers_hold(witness):
    """A plain Lock taken by one thread and released by another is no
    longer held by the first: a lock the first takes afterwards is not
    nested in it."""
    ns = _port_frame("import threading\n"
                     "L = threading.Lock()\n"
                     "M = threading.Lock()\n")
    taken, released = threading.Event(), threading.Event()

    def first():
        ns["L"].acquire()
        taken.set()
        released.wait(10)
        with ns["M"]:
            pass

    def second():
        taken.wait(10)
        ns["L"].release()
        released.set()

    _run_threads(first, second)
    assert witness.edges() == {}, witness.edges()


def test_shared_flock_hands_off_without_a_thread_owned_lock(witness):
    """SharedFlock's hand-off: the first holder takes the file lock, a
    second joins, the first leaves and takes another lock while the
    second still holds its share, then the second releases the file
    lock. The first holder's lock must not read as nested in the Flock
    (the hot restart's concurrent prepares made that edge, which no
    static path explains)."""
    from tpu_dra_torch.infra.flock import Flock, SharedFlock

    with tempfile.TemporaryDirectory() as tmp:
        ns = _port_frame("import threading\n"
                         "shared = SharedFlock(Flock(path))\n"
                         "other = threading.Lock()\n",
                         Flock=Flock, SharedFlock=SharedFlock,
                         path=os.path.join(tmp, "f.lock"))
        shared, other = ns["shared"], ns["other"]
        joined, left = threading.Event(), threading.Event()

        def first():
            shared.acquire()
            joined.wait(10)
            shared.release()      # not the last out: the file stays locked
            with other:
                pass
            left.set()

        def second():
            shared.acquire()
            joined.set()
            left.wait(10)
            shared.release()      # the last out unlocks the file

        _run_threads(first, second)
    assert not [e for e in witness.edges() if "flock.py" in e[0]], \
        witness.edges()
    assert witness.cycles() == []


# -- the session plugin -------------------------------------------------------

CYCLE = '''
import threading

SRC = """
import threading
A = threading.Lock()
B = threading.Lock()

def a_then_b():
    with A:
        with B:
            pass

def b_then_a():
    with B:
        with A:
            pass
"""


def test_opposite_orders():
    ns = {}
    exec(compile(SRC, "/planted/tpu_dra_torch/planted.py", "exec"), ns)
    for fn in (ns["a_then_b"], ns["b_then_a"]):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
'''

DRIFT = '''
from tpu_dra_torch.k8s import informer


def test_mutates_a_view():
    view = {"metadata": {"name": "v0", "namespace": "default"}}
    informer.SHADOW.record(view)
    view["metadata"]["labels"] = {"mutated": "yes"}
'''

CLEAN = '''
import sys
import threading

from tpu_dra_torch.infra import lockwitness


def test_only_the_ports_witness_is_installed():
    assert lockwitness.installed()
    assert threading.Lock is lockwitness._lock_factory
    ref = sys.modules.get("tpu_dra.infra.lockwitness")
    assert ref is None or not ref.installed()
'''


def _plugin_run(tmp_path, monkeypatch, body):
    """One step_suites run of `body` as a test file, the repo's conftest
    beside it, with TPU_DRA_LOCK_WITNESS set around the runner (the
    runner's environment must drop it)."""
    monkeypatch.setenv("TPU_DRA_LOCK_WITNESS", "1")
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    shutil.copy(REPO / "tests" / "conftest.py", tmp_path / "conftest.py")
    test = tmp_path / "test_planted.py"
    test.write_text(textwrap.dedent(body))
    edges, drifts = tmp_path / "edges.json", tmp_path / "drifts.json"
    res = runner.step_suites(paths=[str(test)], iterations=1,
                             edges=edges, drifts=drifts)
    return (res, json.loads(edges.read_text())["edges"],
            json.loads(drifts.read_text())["drifts"])


def test_plugin_fails_a_lock_order_cycle(tmp_path, monkeypatch):
    res, edges, drifts = _plugin_run(tmp_path, monkeypatch, CYCLE)
    assert not res["ok"] and res["runs"][0]["returncode"] == 3, res
    assert "lock-order witness cycles" in res["runs"][0]["tail"]
    planted = {tuple(e) for e in edges if "planted.py" in e[0]}
    assert planted == {("tpu_dra_torch/planted.py:3",
                        "tpu_dra_torch/planted.py:4"),
                       ("tpu_dra_torch/planted.py:4",
                        "tpu_dra_torch/planted.py:3")}
    assert drifts == []


def test_plugin_fails_a_view_drift(tmp_path, monkeypatch):
    res, _edges, drifts = _plugin_run(tmp_path, monkeypatch, DRIFT)
    assert not res["ok"] and res["runs"][0]["returncode"] == 3, res
    assert drifts == [{"site": "test_planted.py:7", "key": "default/v0"}]


def test_plugin_passes_a_clean_file(tmp_path, monkeypatch):
    res, _edges, drifts = _plugin_run(tmp_path, monkeypatch, CLEAN)
    assert res["ok"], res
    assert "1 passed" in res["runs"][0]["summary"]
    assert drifts == []


# -- the runner's steps at a small size ----------------------------------------

def test_runner_steps_small(tmp_path):
    """One witnessed run of one HA test (two Schedulers behind electors),
    then the check over its exports: the edges it observed are all in
    the static lock-order graph, and no drift."""
    edges, drifts = tmp_path / "edges.json", tmp_path / "drifts.json"
    suite = runner.step_suites(
        paths=["tests/test_torch_leaderelect.py::TestSchedulerHAFailover::"
               "test_standby_promotes_on_expiry"],
        iterations=1, edges=edges, drifts=drifts)
    assert suite["ok"], suite
    assert "1 passed" in suite["runs"][0]["summary"]
    check = runner.step_check(edges, drifts)
    assert check["ok"], check
    assert check["witness"]["observed"] > 0
    assert check["witness"]["unexplained"] == 0
    assert check["view_shadow"]["unexplained"] == 0


def test_gencrd_writes_the_charts_file(tmp_path):
    out = gencrd.write(tmp_path / "crd.yaml")
    assert out.read_text() == gencrd.OUT.read_text()
    assert out.read_text().startswith(gencrd.HEADER)
