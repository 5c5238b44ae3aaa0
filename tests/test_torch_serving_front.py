"""euler_tpu_torch's serving front end and RPC substrate against the JAX
package's: wire frames byte for byte, each package's client served by the
other's server, the micro-batcher's admission control, the routing
policies, the registries, the launch counters under threads and the
serve CLI's selftest.

Every socket test binds port 0, gives its clients a deadline, joins its
threads with a timeout and stops its servers in `finally`.
"""

import io
import json
import socket
import sys
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from euler_tpu.distributed import errors as jerrors
from euler_tpu.distributed import wire as jwire
from euler_tpu.distributed.rendezvous import TcpRegistry as JaxTcpRegistry
from euler_tpu.graph import format as jformat
from euler_tpu.serving import ModelServer as JaxModelServer
from euler_tpu.serving import ServingClient as JaxServingClient
from euler_tpu.serving.router import ConsistentHashPolicy as JaxConsistentHash
from euler_tpu.serving.router import LeastLoadedPolicy as JaxLeastLoaded
from euler_tpu.serving.router import _ReplicaState as JaxReplicaState
from euler_tpu.training.checkpoint import CheckpointStore as JaxCheckpointStore
from euler_tpu.training.checkpoint import watch_signature as jax_watch_signature
from euler_tpu_torch.distributed import chaos, errors, wire
from euler_tpu_torch.distributed.chaos import Fault, FaultPlan
from euler_tpu_torch.distributed.registry import Registry
from euler_tpu_torch.distributed.rendezvous import (
    RendezvousServer,
    TcpRegistry,
    make_registry,
)
from euler_tpu_torch.distributed.retry import RetryBudget
from euler_tpu_torch.graph import format as pformat
from euler_tpu_torch.ops import _build
from euler_tpu_torch.serving import (
    ConsistentHashPolicy,
    DeadlineExceededError,
    LeastLoadedPolicy,
    MicroBatcher,
    ModelServer,
    OverloadError,
    ServingClient,
    ServingRouter,
    TenantQuota,
)
from euler_tpu_torch.serving.router import _ReplicaState
from euler_tpu_torch.tools import serve as serve_tool
from euler_tpu_torch.training.checkpoint import watch_signature

torch.set_num_threads(1)

JOIN_S = 20.0
DEADLINE_MS = 10_000.0
IDS = np.arange(1, 49, dtype=np.uint64)


# ---------------------------------------------------------------------------
# fake runtimes (numpy; no model, no compile)
# ---------------------------------------------------------------------------


def _rows(ids) -> np.ndarray:
    ids = np.asarray(ids, np.uint64).astype(np.float64)
    return np.stack([ids * 0.5, ids + 1.0, np.sin(ids)], axis=1).astype(np.float32)


class _FakeRuntime:
    """Duck-typed runtime: rows a function of the ids only; `gate`
    (when given) blocks the device until the test opens it."""

    def __init__(self, gate=None, delay_s=0.0):
        self.gate = gate
        self.delay_s = delay_s
        self.device_batches = 0
        self.buckets = (8,)
        self.reloads = 0

    def predict(self, ids):
        if self.gate is not None:
            assert self.gate.wait(timeout=JOIN_S), "test never opened the gate"
        if self.delay_s:
            time.sleep(self.delay_s)
        self.device_batches += 1
        return _rows(ids)

    def swap(self, cfg=None, params=None, warm=True):
        self.reloads += 1
        return {"reloaded": True, "reloads": self.reloads,
                "warmed_buckets": list(self.buckets), "model_dir": cfg}


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


PACKAGES = {
    "port": (ModelServer, ServingClient, errors),
    "jax": (JaxModelServer, JaxServingClient, jerrors),
}


# ---------------------------------------------------------------------------
# (a) wire frames and error names
# ---------------------------------------------------------------------------


def _values():
    rng = np.random.default_rng(3)
    arrays = []
    for dt in pformat._DTYPE_CODES:
        for shape in ((3, 5), (), (0, 4), (1300,)):  # 1300 × 4+ B: an iovec
            raw = rng.integers(0, 120, size=shape)
            arrays.append(np.asarray(raw).astype(dt))
    return arrays + [
        np.array([True, False, True]), 7, -2**40, np.int32(5), 2.5,
        np.float32(0.25), "ids ✓", "", None, True, False,
        [1, [2.0, "x", None, [np.arange(3, dtype=np.uint64)]], False], (4, 5),
    ]


def test_dtype_tables_match():
    assert pformat._DTYPE_CODES == jformat._DTYPE_CODES
    assert pformat._CODE_DTYPES == jformat._CODE_DTYPES


@pytest.mark.parametrize("op", ["predict", wire.wrap_deadline("predict", 1234.56)])
def test_frames_are_byte_identical_and_cross_decode(op):
    vals = _values()
    flat = wire.encode(op, vals)
    assert bytes(flat) == bytes(jwire.encode(op, vals))
    vec = wire.encode_vectored(op, vals)
    assert b"".join(bytes(p) for p in vec) == bytes(flat)
    assert b"".join(bytes(p) for p in jwire.encode_vectored(op, vals)) == bytes(flat)
    assert wire.frame_nbytes(vec) == jwire.frame_nbytes(flat) == len(flat)
    for borrow in (False, True):
        for dec, enc in ((wire.decode, jwire.encode), (jwire.decode, wire.encode)):
            got_op, got = dec(enc(op, vals)[4:], borrow=borrow)
            want_op, want = jwire.decode(flat[4:])
            assert got_op == want_op == op
            _assert_same_values(got, want)


def _assert_same_values(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_values(x, y)
    else:
        assert a == b


def test_deadline_envelope_and_malformed_frames():
    for budget in (0.001, 12.34, 9e6):
        env = wire.wrap_deadline("reload", budget)
        assert env == jwire.wrap_deadline("reload", budget)
        assert wire.unwrap_deadline(env) == jwire.unwrap_deadline(env)
    assert wire.unwrap_deadline("ping") == ("ping", None)
    good = wire.encode("ok", [np.arange(6, dtype=np.int64)])
    for bad in (good[4:9], b"\x05\x00ab", good[4:-3] + b"\xff"):
        with pytest.raises(ValueError):
            wire.decode(bad)
        with pytest.raises(ValueError):
            jwire.decode(bad)


def test_frames_cross_the_socket_both_ways():
    vals = _values()
    a, b = socket.socketpair()
    try:
        a.settimeout(5)
        b.settimeout(5)
        for send, read, dec in ((wire.send_frame, jwire.read_frame, jwire.decode),
                                (jwire.send_frame, wire.read_frame, wire.decode)):
            send(a, wire.encode_vectored("ok", vals))
            op, got = dec(read(b))
            assert op == "ok"
            _assert_same_values(got, jwire.decode(jwire.encode("ok", vals)[4:])[1])
        a.close()
        assert wire.read_frame(b) is None  # clean EOF
    finally:
        a.close()
        b.close()


def test_error_names_map_identically():
    assert set(errors.WIRE_ERRORS) == set(jerrors.WIRE_ERRORS)
    for name in [*jerrors.WIRE_ERRORS, "ValueError", "NoSuchError"]:
        msg = f"{name}: detail"
        assert type(errors.from_wire(msg)).__name__ == type(jerrors.from_wire(msg)).__name__
        assert str(errors.from_wire(msg)) == str(jerrors.from_wire(msg))
    assert errors.DeadlineExceededError is errors.DeadlineExceeded
    assert issubclass(errors.ReshardFencedError, errors.NotPrimaryError)
    detail = errors.NotPrimaryError.format(3, "follower", 7, ("h", 91))
    assert detail == jerrors.NotPrimaryError.format(3, "follower", 7, ("h", 91))
    assert errors.NotPrimaryError.parse_primary(detail) == ("h", 91)
    assert errors.NotPrimaryError.parse_primary("primary=?") is None


# ---------------------------------------------------------------------------
# (b) each package's client against the other's server
# ---------------------------------------------------------------------------


PAIRS = [("port", "jax"), ("jax", "port"), ("port", "port")]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS,
                         ids=[f"{s}_server-{c}_client" for s, c in PAIRS])
def test_cross_wire_rows_stats_reload_and_typed_errors(server_pkg, client_pkg):
    Server, _, _ = PACKAGES[server_pkg]
    _, Client, errs = PACKAGES[client_pkg]
    runtime = _FakeRuntime()
    server = Server(runtime, max_batch=64, max_wait_us=50_000, workers=8).start()
    gated = _FakeRuntime(gate=threading.Event())
    busy = Server(gated, max_batch=1, max_wait_us=0, max_queue=1, workers=8).start()
    addr, busy_addr = (server.host, server.port), (busy.host, busy.port)
    results, outcomes = {}, {}

    def predict(k):
        c = Client(addr, deadline_ms=DEADLINE_MS)
        try:
            ids = np.roll(IDS, 5 * k)[:6]
            results[k] = (ids, c.predict(ids))
        finally:
            c.close()

    def flood(k):
        c = Client(busy_addr, deadline_ms=DEADLINE_MS)
        try:
            c.predict(IDS[:1])
            outcomes[k] = "ok"
        except errs.OverloadError:
            outcomes[k] = "overload"
        finally:
            c.close()

    client = Client(addr, deadline_ms=DEADLINE_MS)
    threads = [threading.Thread(target=predict, args=(k,)) for k in range(8)]
    floods = [threading.Thread(target=flood, args=(k,)) for k in range(6)]
    try:
        for t in threads:
            t.start()
        _join(threads)
        assert len(results) == 8
        for ids, emb in results.values():
            assert emb.dtype == np.float32
            np.testing.assert_array_equal(emb, _rows(ids))
        stats = client.stats()
        assert stats["requests"] == 8 and stats["batches"] < 8
        want_keys = {"requests", "batches", "rows", "rejected_overload",
                     "rejected_deadline", "errors", "pending", "inflight",
                     "queue_depth", "ewma_batch_ms", "max_batch", "max_wait_us",
                     "max_queue", "device_batches", "buckets", "reloads",
                     "uptime_s", "wire_bytes_in", "wire_bytes_out",
                     "client_wire_bytes_out", "client_wire_bytes_in"}
        assert set(stats) == want_keys
        assert stats["wire_bytes_in"]["predict"] > 0
        assert client.ping()
        assert client.ping_all() == {f"{addr[0]}:{addr[1]}": True}
        report = client.reload("/models/m", canary_ids=IDS[:5])[f"{addr[0]}:{addr[1]}"]
        assert report == {"reloaded": True, "reloads": 1, "warmed_buckets": [8],
                          "model_dir": "/models/m", "canary_n": 5,
                          "canary_parity": True}
        with pytest.raises(errs.DeadlineExceeded):
            client.predict(IDS[:3], deadline_ms=0.001)
        assert client.stats()["rejected_deadline"] == 1
        # a gated device: one request on it, one queued, the rest rejected
        for t in floods:
            t.start()
        deadline = time.monotonic() + JOIN_S
        while (sum(v == "overload" for v in outcomes.values()) < 4
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert sum(v == "overload" for v in outcomes.values()) >= 4, outcomes
        assert gated.device_batches == 0
        gated.gate.set()
        _join(floods)
        assert sum(v == "ok" for v in outcomes.values()) >= 1, outcomes
    finally:
        gated.gate.set()
        client.close()
        server.stop()
        busy.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_unknown_op_gets_a_clean_error_frame(server_pkg):
    Server = PACKAGES[server_pkg][0]
    server = Server(_FakeRuntime(), workers=2).start()
    try:
        with socket.create_connection((server.host, server.port), timeout=5) as s:
            wire.send_frame(s, wire.encode("no_such_verb", []))
            status, vals = wire.decode(wire.read_frame(s))
            assert status == "err" and "unknown op 'no_such_verb'" in vals[0]
            # the connection stays usable
            wire.send_frame(s, wire.encode("ping", []))
            assert wire.decode(wire.read_frame(s)) == ("ok", [0])
    finally:
        server.stop()


def test_verb_tables_match_the_reference():
    assert ModelServer.HANDLED_VERBS == JaxModelServer.HANDLED_VERBS
    assert ServingClient.WIRE_VERBS == JaxServingClient.WIRE_VERBS
    assert set(ServingClient.WIRE_VERBS) == set(ModelServer.HANDLED_VERBS)


# ---------------------------------------------------------------------------
# (c) the micro-batcher and the tenant quota
# ---------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_requests():
    runtime = _FakeRuntime(delay_s=0.005)
    batcher = MicroBatcher(runtime, max_batch=64, max_wait_us=20_000)
    futs = [batcher.submit(np.roll(IDS, k)[:4]) for k in range(12)]
    try:
        for k, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=JOIN_S), _rows(np.roll(IDS, k)[:4]))
        st = batcher.stats()
        assert st["requests"] == 12 and st["batches"] < 12 and st["rows"] == 48
        assert st["inflight"] == 0 and st["queue_depth"] == 0
    finally:
        batcher.close()


def test_batcher_overload_fast_fails_not_hangs():
    batcher = MicroBatcher(_FakeRuntime(delay_s=0.15), max_batch=1, max_wait_us=0, max_queue=2)
    try:
        t0 = time.monotonic()
        futures = []
        with pytest.raises(OverloadError, match="queue full"):
            for _ in range(20):
                futures.append(batcher.submit(np.ones(1, np.uint64)))
        assert time.monotonic() - t0 < 1.0
        assert futures and batcher.stats()["rejected_overload"] >= 1
        for f in futures:  # admitted work still completes
            assert f.result(timeout=JOIN_S).shape == (1, 3)
    finally:
        batcher.close()


def test_batcher_rejects_expired_request_before_dispatch():
    runtime = _FakeRuntime(gate=threading.Event())
    batcher = MicroBatcher(runtime, max_batch=1, max_wait_us=0, max_queue=8)
    try:
        a = batcher.submit(np.ones(1, np.uint64))
        deadline = time.monotonic() + JOIN_S
        while batcher.stats()["pending"] and time.monotonic() < deadline:
            time.sleep(0.005)  # a is on the (gated) device
        b = batcher.submit(np.ones(1, np.uint64), deadline=time.monotonic() + 0.05)
        time.sleep(0.15)
        runtime.gate.set()
        assert a.result(timeout=JOIN_S).shape == (1, 3)
        with pytest.raises(DeadlineExceededError, match="before dispatch"):
            b.result(timeout=JOIN_S)
        assert batcher.stats()["rejected_deadline"] == 1
        assert runtime.device_batches == 1
    finally:
        runtime.gate.set()
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.ones(1, np.uint64))
    with pytest.raises(ValueError):
        MicroBatcher(runtime, max_queue=0)


def test_tenant_quota_qps_pending_and_bounded_tracking():
    q = TenantQuota(qps=1e-6, burst=2)  # ~no refill inside the test
    q.admit("a")
    q.admit("a")
    with pytest.raises(OverloadError, match="tenant 'a'.*qps quota"):
        q.admit("a")
    q.admit("b")  # a's exhaustion never touches b
    s = q.stats()
    assert s["a"]["rejected"] == 1 and s["b"]["rejected"] == 0
    p = TenantQuota(max_pending=1)
    p.admit("x")
    with pytest.raises(OverloadError, match="pending quota"):
        p.admit("x")
    p.release("x")
    p.admit("x")
    bounded = TenantQuota(qps=1000.0)
    bounded.MAX_TRACKED = 8
    for i in range(50):
        bounded.admit(f"t{i}")
        bounded.release(f"t{i}")
    assert len(bounded.stats()) <= 8


def test_tenant_over_quota_is_rejected_through_the_batcher():
    runtime = _FakeRuntime(gate=threading.Event())
    batcher = MicroBatcher(runtime, max_batch=1, max_wait_us=0, max_queue=32,
                           tenant_quota=TenantQuota(max_pending=2))
    try:
        held = [batcher.submit(np.ones(1, np.uint64), tenant="A") for _ in range(2)]
        with pytest.raises(OverloadError, match="tenant 'A'"):
            batcher.submit(np.ones(1, np.uint64), tenant="A")
        other = batcher.submit(np.ones(1, np.uint64), tenant="B")
        runtime.gate.set()
        for f in held + [other]:
            f.result(timeout=JOIN_S)
        tenants = batcher.stats()["tenants"]
        assert tenants["A"]["rejected"] == 1 and tenants["B"]["admitted"] == 1
    finally:
        runtime.gate.set()
        batcher.close()


# ---------------------------------------------------------------------------
# (d) routing policies against the reference's, and the router
# ---------------------------------------------------------------------------


ADDRS = [("10.0.0.1", 9000), ("10.0.0.2", 9000), ("10.0.0.3", 9001), ("10.0.0.4", 7)]


def test_consistent_hash_picks_the_reference_replica():
    port = ConsistentHashPolicy([_ReplicaState(h, p, i) for i, (h, p) in enumerate(ADDRS)])
    rev = ConsistentHashPolicy([_ReplicaState(h, p, i) for i, (h, p) in enumerate(ADDRS[::-1])])
    ref = JaxConsistentHash([JaxReplicaState(h, p, i) for i, (h, p) in enumerate(ADDRS)])
    rng = np.random.default_rng(0)
    primaries = set()
    for k in range(64):
        ids = rng.integers(1, 10**6, size=1 + k % 7).astype(np.uint64)
        want = [st.key() for st in ref.order(ids)]
        assert [st.key() for st in port.order(ids)] == want
        assert [st.key() for st in rev.order(ids)] == want
        primaries.add(want[0])
    assert len(primaries) > 1


def test_least_loaded_ranks_as_the_reference():
    rng = np.random.default_rng(1)
    for _ in range(20):
        port = [_ReplicaState(h, p, i) for i, (h, p) in enumerate(ADDRS)]
        ref = [JaxReplicaState(h, p, i) for i, (h, p) in enumerate(ADDRS)]
        for a, b in zip(port, ref):
            a.inflight = b.inflight = int(rng.integers(0, 3))
            a.queue_depth = b.queue_depth = int(rng.integers(0, 3))
            a.ewma_batch_ms = b.ewma_batch_ms = float(rng.integers(0, 2))
        ids = np.ones(1, np.uint64)
        assert ([st.key() for st in LeastLoadedPolicy(port).order(ids)]
                == [st.key() for st in JaxLeastLoaded(ref).order(ids)])
    with pytest.raises(ValueError, match="unknown routing policy"):
        ServingRouter([("127.0.0.1", 1)], policy="no_such_policy")


def test_router_hedges_a_straggler_fails_over_and_caps_hedges():
    servers = [ModelServer(_FakeRuntime(), max_wait_us=0, shard=i, workers=4).start()
               for i in range(2)]
    addrs = [(s.host, s.port) for s in servers]
    chaos.install(FaultPlan([Fault(site="server", kind="delay", op="predict",
                                   shard=1, delay_s=0.25)], seed=3))
    budget = RetryBudget()  # cap 16, refill 0.5 a success
    hedged = ServingClient(addrs, deadline_ms=DEADLINE_MS, routing=ServingRouter(
        addrs, hedge=True, hedge_ms=15.0, hedge_budget=budget))
    try:
        lats = []
        for k in range(10):
            ids = np.roll(IDS, 5 * k)[:6]
            t0 = time.monotonic()
            np.testing.assert_array_equal(hedged.predict(ids), _rows(ids))
            lats.append(time.monotonic() - t0)
        st = hedged.router.stats()
        assert st["hedges"] >= 1 and st["hedges_won"] >= 1, st
        assert st["hedges"] <= budget.cap + budget.refill * st["rpc_count"], st
        assert max(lats) < 0.25, lats
        assert set(hedged.fleet_stats()) == {f"{h}:{p}" for h, p in addrs}
        chaos.uninstall()
        # a dead replica costs a failover, not an error
        servers.pop(0).stop()
        unhedged = ServingClient(addrs, deadline_ms=DEADLINE_MS,
                                 routing=ServingRouter(addrs, hedge=False))
        try:
            for k in range(4):
                ids = np.roll(IDS, 3 * k)[:5]
                np.testing.assert_array_equal(unhedged.predict(ids), _rows(ids))
            assert unhedged.ping_all()[f"{addrs[0][0]}:{addrs[0][1]}"] is False
        finally:
            unhedged.close()
    finally:
        chaos.uninstall()
        hedged.close()
        for s in servers:
            s.stop()


# ---------------------------------------------------------------------------
# registries, the reload watcher
# ---------------------------------------------------------------------------


def test_registries_register_lookup_and_cross_package(tmp_path):
    reg = make_registry(str(tmp_path / "reg"), ttl=3.0)
    assert isinstance(reg, Registry)
    rdv = RendezvousServer(ttl=3.0).start()
    stops = []
    try:
        tcp = make_registry(f"tcp://{rdv.address}", ttl=3.0)
        assert isinstance(tcp, TcpRegistry)
        for r in (reg, tcp):
            stops += [r.register(0, "127.0.0.1", 5000), r.register(1, "127.0.0.1", 5001)]
        for r in (reg, tcp, JaxTcpRegistry(rdv.address, ttl=3.0)):
            table = r.wait_for(2, timeout=JOIN_S)
            assert table == {0: [("127.0.0.1", 5000)], 1: [("127.0.0.1", 5001)]}
        for r in (reg, tcp):
            with pytest.raises(NotImplementedError):
                r.acquire_lease("shard_0", "h:1", 1.0)
        with pytest.raises(RuntimeError, match="NotImplementedError"):
            JaxTcpRegistry(rdv.address).observe("shard_0")
    finally:
        for s in stops:
            s.set()
        rdv.stop()


def test_watch_signature_and_reload_watcher(tmp_path):
    root = str(tmp_path / "m")
    leaves = [np.ones(3, np.float32)]
    assert watch_signature(root) == jax_watch_signature(root) == ("none", 0, 0.0)
    JaxCheckpointStore(root).save_leaves(3, leaves, [])
    (tmp_path / "m" / "ckpt_000000000009.tmp-7").mkdir()  # a save in flight
    assert watch_signature(root) == jax_watch_signature(root)
    assert watch_signature(root)[:2] == ("retained", 3)

    class _Server:
        host, port = "127.0.0.1", 1

        def __init__(self):
            self.runtime = _FakeRuntime()

    servers = [_Server(), _Server()]
    stop = threading.Event()
    out = io.StringIO()
    with redirect_stdout(out):
        watcher = threading.Thread(target=serve_tool.watch_reload,
                                   args=(servers, root, stop, 0.02))
        watcher.start()
        try:
            time.sleep(0.1)
            assert [s.runtime.reloads for s in servers] == [0, 0]
            JaxCheckpointStore(root).save_leaves(5, leaves, [])
            deadline = time.monotonic() + JOIN_S
            while (any(s.runtime.reloads == 0 for s in servers)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            stop.set()
            watcher.join(timeout=JOIN_S)
    assert not watcher.is_alive()
    assert [s.runtime.reloads for s in servers] == [1, 1]
    assert out.getvalue().count("hot-reloaded") == 2


# ---------------------------------------------------------------------------
# (f) the CLI's selftest, (g) the launch counters under threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_serve_selftest_on_cpu(replicas, capsys, tmp_path):
    """The selftest, and (once) `--conv gcn` and `--conv gat` checkpoints
    of the port's trainer served by `build_runtime --conv`: rows bitwise
    the trainer's restored `Estimator.infer`."""
    argv = ["--selftest", "--device", "cpu", "--replicas", str(replicas)]
    assert serve_tool.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["selftest"] == "ok" and out["replicas"] == replicas
    assert out["durability"] == "not ported" and out["coalesced"]
    if replicas > 1:
        assert out["reload_parity"] is True
    with pytest.raises(NotImplementedError):
        serve_tool.main(["--selftest", "--device", "cpu", "--replication", "2"])
    if replicas == 1:
        for conv in ("gcn", "gat"):
            _serve_a_trained_conv(tmp_path / conv, conv)


def _serve_a_trained_conv(tmp_path, conv):
    from euler_tpu_torch.datasets.synthetic import random_graph
    from euler_tpu_torch.estimator import id_batches
    from euler_tpu_torch.graph import write_arrays
    from euler_tpu_torch.tools import train as train_tool

    data, model_dir = str(tmp_path / "graph"), str(tmp_path / "ckpt")
    g = random_graph(num_nodes=60, out_degree=4, feat_dim=8, seed=7)
    for p, shard in enumerate(g.shards):
        write_arrays(f"{data}/part_{p}", shard.arrays)
    g.meta.save(data)
    common = ["--data", data, "--model-dir", model_dir, "--dims", "8,8", "--conv", conv,
              "--max-degree", "4", "--device", "cpu"]
    with redirect_stdout(io.StringIO()):
        assert train_tool.main(common + ["--total-steps", "3", "--checkpoint-every", "3"]) == 0
    _, est, _, graph = train_tool.build_trainer(train_tool.build_parser().parse_args(common))
    assert est.restore() and est.step == 3
    runtime = serve_tool.build_runtime(serve_tool.build_parser().parse_args(
        common + ["--full-neighbor", "--label-feature", "label", "--buckets", "16"]))
    ids = np.arange(1, 41, dtype=np.uint64)
    _, want = est.infer(*id_batches(runtime.flow, ids, 16))
    np.testing.assert_array_equal(runtime.predict(ids), want)


def test_launch_counts_are_exact_under_threads():
    """7 threads count launches while an 8th holds a capture open: the sums
    are exact, and the capture neither erases the others' launches nor
    takes any of them (a CUDA-graph capture beside a fleet's dispatchers)."""
    per_thread, threads_n = 3000, 8
    opened, counted = threading.Event(), threading.Event()
    captured = {}

    def count(k):
        assert opened.wait(timeout=JOIN_S)
        for _ in range(per_thread):
            _build.count_launch("gather_weighted_sum")
        _build.add_launches({"paged_sample_hop": k})

    def capture():
        with _build.uncounted_launches() as c:
            opened.set()
            for i in range(per_thread):
                _build.count_launch("gather_weighted_sum")
                _build.count_launch("gather_weighted_sum_dx")
            assert counted.wait(timeout=JOIN_S)
        captured.update(c)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads between any two bytecodes
    _build.reset_launch_counts()
    try:
        counters = [threading.Thread(target=count, args=(k,)) for k in range(threads_n - 1)]
        holder = threading.Thread(target=capture)
        holder.start()
        for t in counters:
            t.start()
        _join(counters)
        counted.set()
        _join([holder])
    finally:
        sys.setswitchinterval(switch)
    counts = _build.launch_counts()
    assert counts["gather_weighted_sum"] == per_thread * (threads_n - 1)
    assert counts["paged_sample_hop"] == sum(range(threads_n - 1))
    assert counts["gather_weighted_sum_dx"] == 0
    assert captured["gather_weighted_sum"] == captured["gather_weighted_sum_dx"] == per_thread
    assert captured["paged_sample_hop"] == 0
    _build.reset_launch_counts()
