"""The port's watch and informer (tpu_dra_torch.k8s: fake.FakeCluster's
watch, informer.Informer, ShardDispatcher) against the reference's
(tpu_dra.k8s).

The FakeCluster watch cases of tests/test_informer_scale.py, run on the
port: field-selector-indexed registration, bookmark resume across
compacted history and bounded watcher queues; then its
ShardDispatcher, partitioned-informer and scheduler shard-recovery cases
(TestShardDispatcher, TestPartitionedInformer, TestSchedulerShardRecovery)
on the port's informer.ShardDispatcher, Informer(partitions=...) and
simcluster.scheduler.Scheduler, a view-shadow drift case, and the
dispatcher's routing held equal to the reference's over the same keys
(exact). Then one scripted series of creates, updates, deletes and two
forced relists (one of them across a delete) on both packages'
FakeClusters: the informers' handler event sequences must be equal,
event for event; and the retrying client's watch across dropped
streams.
"""

import threading
import time

import pytest

from tpu_dra_torch.infra.faults import FAULTS, OneShot
from tpu_dra_torch.k8s import FakeCluster, Informer, PODS
from tpu_dra_torch.k8s import informer as informer_mod
from tpu_dra_torch.k8s.client import (
    field_path_value, field_selector_matches, parse_field_selector,
)
from tpu_dra_torch.k8s.informer import ShardDispatcher


@pytest.fixture(autouse=True)
def _reset_port_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def pod(name, ns="default", node=None, labels=None):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns}, "spec": {}}
    if node:
        obj["spec"]["nodeName"] = node
    if labels:
        obj["metadata"]["labels"] = labels
    return obj


def collect(cluster, stop, out, **watch_kwargs):
    def consume():
        for evt in cluster.watch(PODS, namespace="default", stop=stop,
                                 **watch_kwargs):
            out.append(evt)
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    return t


class TestFieldSelectorParsing:
    def test_single_equality_term(self):
        assert parse_field_selector("spec.nodeName=n5") == \
            (("spec", "nodeName"), "n5")

    @pytest.mark.parametrize("bad", [
        "", "spec.nodeName", "a!=b", "a=b,c=d", "=v", "k="])
    def test_unsupported_shapes_raise(self, bad):
        with pytest.raises(ValueError):
            parse_field_selector(bad)

    def test_path_value_and_match(self):
        obj = pod("p", node="n3")
        assert field_path_value(obj, ("spec", "nodeName")) == "n3"
        assert field_path_value(obj, ("spec", "missing")) is None
        assert field_selector_matches("spec.nodeName=n3", obj)
        assert not field_selector_matches("spec.nodeName=n4", obj)
        assert field_selector_matches(None, obj)


class TestScopedWatch:
    def test_node_scoped_watcher_never_sees_other_nodes(self):
        """The isolation contract, end to end: a spec.nodeName=n1 watch
        receives every event for n1's pods (including the MODIFIED that
        binds one, and DELETEs) and not a single event for any other
        node — the emit path does not even iterate the watcher for
        them."""
        c = FakeCluster()
        stop = threading.Event()
        events = []
        t = collect(c, stop, events, field_selector="spec.nodeName=n1")
        time.sleep(0.05)

        c.create(PODS, pod("mine-a", node="n1"))
        for i in range(50):
            c.create(PODS, pod(f"other-{i}", node=f"n{2 + i % 7}"))
        unbound = c.create(PODS, pod("late-bind"))  # broadcast-only so far
        unbound["spec"]["nodeName"] = "n1"
        c.update(PODS, unbound)                     # now reaches the scope
        for i in range(50):
            c.delete(PODS, f"other-{i}", "default")
        c.delete(PODS, "mine-a", "default")

        assert c.wait_for(lambda: sum(1 for e in events
                                      if e[0] == "DELETED") >= 1)
        stop.set()
        t.join(2)
        real = [e for e in events if e[0] != "BOOKMARK"]
        assert real, "scoped watcher saw nothing"
        for ev, obj in real:
            assert obj["spec"]["nodeName"] == "n1", (ev, obj)
        names = {o["metadata"]["name"] for _, o in real}
        assert names == {"mine-a", "late-bind"}

    def test_stream_opens_with_bookmark(self):
        c = FakeCluster()
        c.create(PODS, pod("seed", node="n9"))
        stop = threading.Event()
        events = []
        t = collect(c, stop, events, field_selector="spec.nodeName=n1")
        assert c.wait_for(lambda: len(events) >= 1)
        stop.set()
        t.join(2)
        ev, obj = events[0]
        assert ev == "BOOKMARK"
        assert obj["metadata"]["resourceVersion"] == str(int(
            c.list_with_rv(PODS, namespace="default")[1]))


class TestBookmarkResume:
    def test_scoped_resume_skips_compacted_dead_range_without_relist(self):
        """The tentpole's bookmark semantics: after the event log trims
        a range containing ONLY other nodes' churn, a scoped watch
        resuming from before the trim point succeeds (replays nothing,
        bookmarks forward) instead of 410-relisting — the per-topic
        watermark proves the dead range held nothing for it."""
        c = FakeCluster()
        c.EVENT_LOG_CAP = 16
        # Register the topic before the churn so per-topic watermarks
        # cover the whole trimmed range (kubelet watches start at node
        # boot, before churn — same ordering).
        warm_stop = threading.Event()
        warm = []
        wt = collect(c, warm_stop, warm, field_selector="spec.nodeName=n1")
        assert c.wait_for(lambda: len(warm) >= 1)  # registered (BOOKMARK)
        _, resume_rv = c.list_with_rv(PODS, namespace="default")
        warm_stop.set()
        wt.join(2)

        for i in range(100):  # churn far past the cap — all other nodes
            c.create(PODS, pod(f"noise-{i}", node=f"n{2 + i % 5}"))
        assert c._trimmed_rv > int(resume_rv)  # the range really is dead

        stop = threading.Event()
        events = []
        t = collect(c, stop, events, field_selector="spec.nodeName=n1",
                    resource_version=resume_rv)
        assert c.wait_for(lambda: len(events) >= 1)
        assert events[0][0] == "BOOKMARK", events[0]
        c.create(PODS, pod("fresh", node="n1"))
        assert c.wait_for(lambda: len(events) >= 2)
        stop.set()
        t.join(2)
        assert events[1][0] == "ADDED"
        assert events[1][1]["metadata"]["name"] == "fresh"

    def test_scoped_resume_past_matching_trimmed_event_gets_410(self):
        """The watermark must refuse what it cannot prove: when a
        MATCHING event was trimmed, the scoped resume 410s like any
        other hole."""
        c = FakeCluster()
        c.EVENT_LOG_CAP = 16
        warm_stop = threading.Event()
        warm = []
        wt = collect(c, warm_stop, warm, field_selector="spec.nodeName=n1")
        assert c.wait_for(lambda: len(warm) >= 1)
        _, resume_rv = c.list_with_rv(PODS, namespace="default")
        warm_stop.set()
        wt.join(2)

        c.create(PODS, pod("mine", node="n1"))  # matching, will be trimmed
        for i in range(100):
            c.create(PODS, pod(f"noise-{i}", node="n2"))

        stop = threading.Event()
        gen = c.watch(PODS, namespace="default", stop=stop,
                      field_selector="spec.nodeName=n1",
                      resource_version=resume_rv)
        ev, obj = next(gen)
        stop.set()
        assert ev == "ERROR"
        assert obj["code"] == 410

    def test_unscoped_resume_past_trim_still_410(self):
        """Broadcast watchers keep the strict contract: any trimmed
        range is a hole (no per-topic proof exists for them)."""
        c = FakeCluster()
        c.EVENT_LOG_CAP = 8
        first = c.create(PODS, pod("p-0"))
        for i in range(1, 30):
            c.create(PODS, pod(f"p-{i}"))
        stop = threading.Event()
        gen = c.watch(PODS, namespace="default", stop=stop,
                      resource_version=first["metadata"]["resourceVersion"])
        ev, obj = next(gen)
        stop.set()
        assert ev == "ERROR"
        assert obj["code"] == 410

    def test_path_registered_after_trim_cannot_vouch_for_old_history(self):
        """A field path first registered NOW has no watermarks for
        already-trimmed history: a resume from below the trim point
        must 410 even if no matching event happens to have existed."""
        c = FakeCluster()
        c.EVENT_LOG_CAP = 8
        first = c.create(PODS, pod("p-0", node="n2"))
        for i in range(1, 30):
            c.create(PODS, pod(f"p-{i}", node="n2"))
        stop = threading.Event()
        gen = c.watch(PODS, namespace="default", stop=stop,
                      field_selector="spec.nodeName=n1",
                      resource_version=first["metadata"]["resourceVersion"])
        ev, obj = next(gen)
        stop.set()
        assert ev == "ERROR"
        assert obj["code"] == 410


class TestWatcherQueueBound:
    def test_overflowed_watcher_drains_then_410s(self):
        """A too-slow watcher is ended the way the real apiserver ends
        one: buffered events drain in order, then the stream errors so
        the consumer relists. The emit path never blocks."""
        c = FakeCluster()
        c.WATCH_QUEUE_CAP = 8
        stop = threading.Event()
        gen = c.watch(PODS, namespace="default", stop=stop)
        first = []
        t = threading.Thread(target=lambda: first.append(next(gen)),
                             daemon=True)
        t.start()  # registration happens as the generator body starts
        time.sleep(0.05)
        c.create(PODS, pod("first"))
        t.join(2)
        assert first and first[0][0] == "ADDED"
        # Nobody consuming now: blow far past the queue bound.
        for i in range(40):
            c.create(PODS, pod(f"flood-{i}"))
        drained = list(gen)  # buffered prefix, then the 410 terminator
        stop.set()
        assert drained, "expected buffered events then an ERROR"
        types = [ev for ev, _ in drained]
        assert types[-1] == "ERROR"
        assert drained[-1][1]["code"] == 410
        # In-order prefix, not a random sample.
        names = [o["metadata"]["name"] for ev, o in drained[:-1]]
        assert names == [f"flood-{i}" for i in range(len(names))]
        assert len(names) <= c.WATCH_QUEUE_CAP

    def test_overflow_via_informer_relists_and_converges(self):
        """End to end: a watcher queue blown past its bound 410s, the
        informer relists, and the cache converges to cluster truth."""
        c = FakeCluster()
        c.WATCH_QUEUE_CAP = 4
        inf = Informer(c, PODS, namespace="default")
        slow = threading.Event()

        # A handler that wedges the watch thread while churn piles up.
        inf.on_add(lambda o: slow.wait(0.3)
                   if o["metadata"]["name"] == "wedge" else None)
        inf.start()
        assert inf.wait_for_sync()
        c.create(PODS, pod("wedge"))
        for i in range(30):  # far past WATCH_QUEUE_CAP while wedged
            c.create(PODS, pod(f"burst-{i}"))
        slow.set()
        assert c.wait_for(
            lambda: len(inf.lister.list()) == 31, timeout=10)
        inf.stop()


# ---------------------------------------------------------------------------
# The informer's event sequence against the reference's
# ---------------------------------------------------------------------------

def _relisting(cluster_cls):
    """A FakeCluster whose watch, once `cut` is set, replaces the next
    event with a 410 ERROR and ends the stream: the informer relists."""

    class Relisting(cluster_cls):
        def __init__(self):
            super().__init__()
            self.cut = threading.Event()

        def watch(self, *args, **kw):
            for event in super().watch(*args, **kw):
                if self.cut.is_set() and event[0] != "BOOKMARK":
                    self.cut.clear()
                    yield self._gone_status("forced relist")
                    return
                yield event

    return Relisting()


def _script(cluster_cls, informer_cls, pods_gvr):
    """Run the script on one package; returns the handler events as
    (handler, name, labels[, new labels])."""
    c = _relisting(cluster_cls)
    events = []
    lock = threading.Lock()

    def rec(*item):
        with lock:
            events.append(item)

    def labels(o):
        return dict(o["metadata"].get("labels") or {})

    c.create(pods_gvr, pod("a", labels={"v": "1"}))
    c.create(pods_gvr, pod("b", node="n1"))
    inf = informer_cls(c, pods_gvr, namespace="default")
    inf.on_add(lambda o: rec("add", o["metadata"]["name"], labels(o)))
    inf.on_update(lambda old, new: rec("update", new["metadata"]["name"],
                                       labels(old), labels(new)))
    inf.on_delete(lambda o: rec("delete", o["metadata"]["name"],
                                labels(o)))
    inf.start()
    try:
        assert inf.wait_for_sync()

        def step(n, fn):
            fn()
            assert c.wait_for(lambda: len(events) >= n, timeout=10), events

        a = c.get(pods_gvr, "a", "default")
        a["metadata"]["labels"] = {"v": "2"}
        step(3, lambda: c.update(pods_gvr, a))
        step(4, lambda: c.create(pods_gvr, pod("c", labels={"v": "c"})))
        step(5, lambda: c.delete(pods_gvr, "b", "default"))
        # Relist across a create: the ADDED of d is the event the cut
        # swallows; the relist re-adds every object (a, c, d).
        c.cut.set()
        step(8, lambda: c.create(pods_gvr, pod("d")))
        # Relist across a delete: c's DELETED is swallowed; the relist
        # finds c gone (delete), then re-adds a and d.
        c.cut.set()
        step(11, lambda: c.delete(pods_gvr, "c", "default"))
        step(12, lambda: c.create(pods_gvr, pod("e")))
        time.sleep(0.2)   # nothing else may arrive
        with lock:
            return list(events), sorted(
                o["metadata"]["name"] for o in inf.lister.list())
    finally:
        inf.stop()


def test_informer_event_sequence_matches_reference():
    """The same script on tpu_dra.k8s's FakeCluster + Informer and on the
    port's: equal event sequences (exact) and equal final caches."""
    from tpu_dra.k8s import FakeCluster as RefCluster
    from tpu_dra.k8s import Informer as RefInformer
    from tpu_dra.k8s import PODS as REF_PODS

    ref, ref_cache = _script(RefCluster, RefInformer, REF_PODS)
    port, port_cache = _script(FakeCluster, Informer, PODS)
    assert port == ref
    assert port_cache == ref_cache == ["a", "d", "e"]
    assert [e[0] for e in port] == [
        "add", "add", "update", "add", "delete", "add", "add", "add",
        "delete", "add", "add", "add"]


def test_retrying_client_watch_resumes_after_drop():
    """The retrying wrapper's watch (k8s.client.RetryingApiClient.watch):
    a dropped stream (k8s.watch.drop) reconnects from the last seen
    resourceVersion, so no event is lost across the gap."""
    from tpu_dra_torch.infra.faults import EveryNth
    from tpu_dra_torch.k8s.client import RetryingApiClient

    c = FakeCluster()
    client = RetryingApiClient(c, base_delay=0.001, max_delay=0.01)
    _, rv = c.list_with_rv(PODS, namespace="default")
    for i in range(6):
        c.create(PODS, pod(f"p{i}"))
    stop = threading.Event()
    FAULTS.arm("k8s.watch.drop", EveryNth(3))
    seen = []
    try:
        for ev, obj in client.watch(PODS, namespace="default",
                                    resource_version=rv, stop=stop):
            seen.append(obj["metadata"]["name"])
            if len(seen) == 6:
                stop.set()
    finally:
        FAULTS.reset()
    assert seen == [f"p{i}" for i in range(6)]


def test_http_watch_and_informer_over_the_wire():
    """The port's HttpApiClient (list_with_rv, its chunked-JSON watch with
    a field selector) and an Informer over it, against the reference's
    FakeApiServer (tpu_dra.k8s.fakeserver) on localhost: a watch resumed
    from the list's resourceVersion sees exactly the later events, a
    node-scoped watch only its node's, and the informer's cache follows
    creates, updates and deletes."""
    from tpu_dra.k8s.fakeserver import FakeApiServer
    from tpu_dra_torch.k8s.client import HttpApiClient

    server = FakeApiServer()
    server.start()
    try:
        api = HttpApiClient(base_url=server.url, timeout=10)
        api.create(PODS, pod("before", node="n1"))
        items, rv = api.list_with_rv(PODS, namespace="default")
        assert [o["metadata"]["name"] for o in items] == ["before"] and rv

        stop = threading.Event()
        seen, scoped = [], []

        def consume(out, **kw):
            for ev, obj in api.watch(PODS, namespace="default", stop=stop,
                                     **kw):
                if ev != "BOOKMARK":
                    out.append((ev, obj["metadata"]["name"]))

        threads = [
            threading.Thread(target=consume, args=(seen,),
                             kwargs={"resource_version": rv}, daemon=True),
            threading.Thread(target=consume, args=(scoped,), kwargs={
                "field_selector": "spec.nodeName=n2"}, daemon=True)]
        for t in threads:
            t.start()
        inf = Informer(api, PODS, namespace="default")
        inf.start()
        try:
            assert inf.wait_for_sync()
            time.sleep(0.2)   # the scoped watch is registered
            api.create(PODS, pod("a", node="n2"))
            b = api.create(PODS, pod("b", node="n1"))
            b["metadata"]["labels"] = {"v": "2"}
            api.update(PODS, b)
            api.delete(PODS, "before", "default")
            assert server.cluster.wait_for(lambda: len(seen) >= 4,
                                           timeout=10), seen
            assert seen == [("ADDED", "a"), ("ADDED", "b"),
                            ("MODIFIED", "b"), ("DELETED", "before")]
            assert server.cluster.wait_for(
                lambda: sorted(o["metadata"]["name"]
                               for o in inf.lister.list()) == ["a", "b"],
                timeout=10)
            assert inf.lister.get("b", "default")["metadata"]["labels"] \
                == {"v": "2"}
            assert server.cluster.wait_for(lambda: scoped, timeout=10)
            time.sleep(0.2)   # b's events, were they to reach it
            assert scoped == [("ADDED", "a")]
        finally:
            stop.set()
            inf.stop()
            for t in threads:
                t.join(timeout=5)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Partitioned dispatch (tests/test_informer_scale.py's ShardDispatcher,
# partitioned-informer and scheduler shard-recovery cases, on the port)
# ---------------------------------------------------------------------------

class TestShardDispatcher:
    def test_routing_matches_allocation_index(self):
        """The alignment the scheduler's recovery depends on: informer
        shard i IS allocation-index shard i for any pool."""
        from tpu_dra_torch.simcluster.scheduler import AllocationIndex
        index = AllocationIndex(n_shards=8)
        for key in ("pool-a", "pool-b", "n17-slice", "x"):
            assert ShardDispatcher.shard_of(key, 8) == index.shard_of(key)

    def test_routing_matches_reference(self):
        """The same keys route to the same shards as under the
        reference's dispatcher (exact), at several shard counts."""
        from tpu_dra.k8s.informer import ShardDispatcher as RefDispatcher
        keys = ([f"n{i:03d}" for i in range(64)]
                + ["default/churn-00017", "chaos-node", "", "gpu-7"])
        for shards in (1, 3, 8, 16):
            ref, port = RefDispatcher(shards), ShardDispatcher(shards)
            assert [port.route(k) for k in keys] == \
                [ref.route(k) for k in keys]

    def test_per_key_order_preserved(self):
        d = ShardDispatcher(4, cap=1024)
        seen = {}
        done = threading.Event()
        total = 200

        def mk(key, i):
            def run():
                seen.setdefault(key, []).append(i)
                if sum(len(v) for v in seen.values()) == total:
                    done.set()
            return run

        d.start()
        try:
            for i in range(total):
                key = f"k{i % 5}"
                assert d.offer(d.route(key), mk(key, i))
            assert done.wait(5)
        finally:
            d.stop()
        for key, order in seen.items():
            assert order == sorted(order), f"{key} reordered: {order}"

    def test_overflow_sheds_and_reports(self):
        drops = []
        d = ShardDispatcher(1, cap=2, on_overflow=lambda sid, why:
                            drops.append((sid, why)))
        # No workers: queue fills at cap, then sheds.
        assert d.offer(0, lambda: None)
        assert d.offer(0, lambda: None)
        assert not d.offer(0, lambda: None)
        assert drops == [(0, "full")]
        assert d.overflows == 1
        # Draining frees capacity again.
        assert d.drain_one(0)
        assert d.offer(0, lambda: None)
        d.stop()

    def test_injected_dispatch_fault_sheds_like_overflow(self):
        drops = []
        d = ShardDispatcher(2, cap=64, on_overflow=lambda sid, why:
                            drops.append((sid, why)))
        FAULTS.arm("sched.watch_shard_dispatch", OneShot())
        try:
            assert not d.offer(1, lambda: None)
        finally:
            FAULTS.disarm("sched.watch_shard_dispatch")
        assert drops == [(1, "fault")]
        assert d.offer(1, lambda: None)  # fault was one-shot
        d.stop()

    def test_flush_is_a_barrier(self):
        d = ShardDispatcher(3, cap=64)
        ran = []
        d.start()
        try:
            for i in range(30):
                d.offer(i % 3, lambda i=i: ran.append(i))
            assert d.flush(timeout=5)
            assert len(ran) == 30
        finally:
            d.stop()


class TestPartitionedInformer:
    def test_partitioned_dispatch_sync_and_events(self):
        c = FakeCluster()
        c.create(PODS, pod("pre", node="n1"))
        adds, deletes = [], []
        inf = Informer(c, PODS, namespace="default", partitions=4,
                       partition_key=lambda o: o["spec"].get("nodeName"))
        inf.on_add(lambda o: adds.append(o["metadata"]["name"]))
        inf.on_delete(lambda o: deletes.append(o["metadata"]["name"]))
        inf.start()
        try:
            assert inf.wait_for_sync()
            # The flush barrier ran: initial adds are HANDLED at sync.
            assert adds == ["pre"]
            for i in range(20):
                c.create(PODS, pod(f"live-{i}", node=f"n{i % 3}"))
            assert c.wait_for(lambda: len(adds) == 21)
            c.delete(PODS, "live-0", "default")
            assert c.wait_for(lambda: deletes == ["live-0"])
        finally:
            inf.stop()

    def test_shard_overflow_reports_to_consumer(self):
        c = FakeCluster()
        overflows = []
        release = threading.Event()
        inf = Informer(c, PODS, namespace="default", partitions=1,
                       partition_key=lambda o: "one-pool",
                       shard_queue_cap=2,
                       on_shard_overflow=lambda sid, why:
                       overflows.append((sid, why)))
        inf.on_add(lambda o: release.wait(2))  # wedge the shard worker
        inf.start()
        try:
            assert inf.wait_for_sync()
            for i in range(8):  # one wedges, cap 2 buffers, rest shed
                c.create(PODS, pod(f"p{i}", node="n1"))
            assert c.wait_for(lambda: len(overflows) >= 1)
            release.set()
            assert overflows[0][0] == 0
        finally:
            release.set()
            inf.stop()


class TestSchedulerShardRecovery:
    def test_overflow_dirties_exactly_the_matching_index_shard(self):
        from tpu_dra_torch.simcluster.scheduler import Scheduler
        c = FakeCluster()
        s = Scheduler(c)
        s.start()
        try:
            sid = 3 % s._index_shards
            s._on_informer_shard_overflow(sid, "full")
            assert s._index.dirty_shards() == [sid]
        finally:
            s.stop()

    def test_faulted_recovery_degrades_to_whole_index_dirty(self):
        from tpu_dra_torch.simcluster.scheduler import Scheduler
        c = FakeCluster()
        s = Scheduler(c)
        s.start()
        try:
            FAULTS.arm("sched.informer_shard_relist", OneShot())
            try:
                s._on_informer_shard_overflow(0, "full")
            finally:
                FAULTS.disarm("sched.informer_shard_relist")
            # Degradation: cannot trust the shard-scoped path — every
            # shard is dirty so the guarded full resync rebuilds all.
            assert len(s._index.dirty_shards()) == s._index_shards
        finally:
            s.stop()


class TestMutationCacheAfterDelete:
    def test_late_write_cannot_resurrect_a_deleted_object(self):
        """A consumer's mutation-cache write of a state older than a
        deletion the watch already delivered is refused (the object
        stays gone, from the lister and the indexes); a recreated object
        under the same name is accepted."""
        c = FakeCluster()
        inf = Informer(c, PODS, namespace="default")
        inf.add_indexer("node", lambda o: [o["spec"].get("nodeName", "")])
        inf.start()
        try:
            assert inf.wait_for_sync()
            c.create(PODS, pod("p", node="n1"))
            assert c.wait_for(lambda: inf.lister.get("p", "default"))
            late = c.get(PODS, "p", "default")   # a write, landing late
            c.delete(PODS, "p", "default")
            assert c.wait_for(lambda: inf.lister.get("p", "default") is None)
            inf.update_cache(late)
            assert inf.lister.get("p", "default") is None
            assert inf.get_by_index("node", "n1") == []
            again = c.create(PODS, pod("p", node="n2"))
            assert c.wait_for(
                lambda: (inf.lister.get("p", "default") or {}).get(
                    "spec", {}).get("nodeName") == "n2")
            inf.update_cache(again)   # its own write: newer, accepted
            assert inf.get_by_index("node", "n2")[0]["metadata"][
                "name"] == "p"
        finally:
            inf.stop()


class TestViewShadow:
    def test_in_place_mutation_of_a_view_is_a_drift(self):
        """A zero-copy informer hands out the cached objects themselves;
        with the shadow on, mutating one in place is reported as a drift
        (naming the object and each site that handed it out, once),
        while a wholesale replacement by a watch event is not."""
        c = FakeCluster()
        c.create(PODS, pod("a", node="n1"))
        c.create(PODS, pod("b", node="n1"))
        inf = Informer(c, PODS, namespace="default", copy_on_read=False,
                       copy_events=False)
        prev = informer_mod.SHADOW.enable()
        snap = informer_mod.SHADOW.snapshot()
        inf.start()
        try:
            assert inf.wait_for_sync()
            views = {o["metadata"]["name"]: o for o in inf.lister.list()}
            assert inf.lister.get("a", "default") is views["a"]
            # b is replaced through the API: a new object, no drift.
            upd = c.get(PODS, "b", "default")
            upd["metadata"]["labels"] = {"x": "1"}
            c.update(PODS, upd)
            assert c.wait_for(lambda: inf.lister.get("b", "default")
                              is not views["b"])
            assert informer_mod.SHADOW.violations_since(snap) == []
            views["a"]["spec"]["nodeName"] = "n2"   # the forbidden write
            drifts = informer_mod.SHADOW.violations_since(snap)
            # One drift per hand-out site of the object (the lister's
            # list and get here, the initial dispatch on the watch
            # thread), each naming it; reported once.
            assert drifts and all("'default/a'" in d
                                  and "mutated in place" in d
                                  for d in drifts)
            assert any("tests/test_torch_informer.py:" in d for d in drifts)
            assert informer_mod.SHADOW.violations_since(snap) == drifts
        finally:
            inf.stop()
            informer_mod.SHADOW.restore(prev)
            informer_mod.SHADOW.reset()
