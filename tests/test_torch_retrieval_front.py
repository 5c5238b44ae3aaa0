"""euler_tpu_torch's retrieval front end against the JAX package's:
RetrievalServer, RetrievalRouter, RetrievalClient and tools/retrieve.py.

The canon is the JAX package's (tests/test_retrieval.py): the FLEET
answer — any shard count, any replica count, mid-hot-swap, mid-replica-
kill, hedged — is BIT-IDENTICAL to the single-process NumPy oracle, and
across the wire either package's client is answered by the other's
servers with the same bits. Parity asserts are `array_equal`, never
`allclose`.

Each fleet is a module fixture that stops its servers in `finally`;
every client is closed in `finally`, and every thread joins with a
timeout. Tests that move the main fleet's corpus version reload it to
the version they start from first, so they do not depend on their order.
"""

import argparse
import concurrent.futures
import json
import threading
import time

import numpy as np
import pytest
import torch

from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.datasets import random_graph as jax_random_graph
from euler_tpu.distributed.errors import OverloadError as JaxOverloadError
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.retrieval import EmbeddingCorpus as JaxEmbeddingCorpus
from euler_tpu.retrieval import client as jax_client_mod
from euler_tpu.retrieval.client import RetrievalClient as JaxRetrievalClient
from euler_tpu.retrieval.server import RetrievalServer as JaxRetrievalServer
from euler_tpu.serving.runtime import InferenceRuntime as JaxInferenceRuntime
from euler_tpu.tools import retrieve as jax_retrieve_tool
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.distributed import chaos
from euler_tpu_torch.distributed.chaos import Fault, FaultPlan
from euler_tpu_torch.distributed.client import _Replica
from euler_tpu_torch.distributed.errors import OverloadError, RpcError
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import from_flax
from euler_tpu_torch.retrieval import EmbeddingCorpus, numpy_topk_oracle
from euler_tpu_torch.retrieval import client as client_mod
from euler_tpu_torch.retrieval.client import RetrievalClient
from euler_tpu_torch.retrieval.router import RetrievalRouter
from euler_tpu_torch.retrieval.server import RetrievalServer
from euler_tpu_torch.serving import InferenceRuntime, TenantQuota
from euler_tpu_torch.tools import retrieve as retrieve_tool

torch.set_num_threads(1)

N, D = 140, 12  # the JAX fleet fixture's corpus (tests/test_retrieval.py:228-246)
JOIN_S = 30.0
DNF = [[("cat", "in", [1, 3])]]


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _join(threads):
    deadline = time.monotonic() + JOIN_S  # one shared budget
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.1))
    assert not any(t.is_alive() for t in threads), "a client thread hung"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    ids = np.sort(rng.choice(9_999, size=N, replace=False).astype(np.uint64))
    tables = {
        1: rng.standard_normal((N, D)).astype(np.float32),
        2: rng.standard_normal((N, D)).astype(np.float32),
    }
    attrs = {"cat": rng.integers(0, 4, size=N)}
    q = rng.standard_normal((4, D)).astype(np.float32)
    return {"ids": ids, "tables": tables, "attrs": attrs, "q": q,
            "mask": np.isin(attrs["cat"], [1, 3])}


def _boot(server_cls, corpora, num_parts, replicas, **kw):
    """Servers over a {'step': N} loader of prebuilt corpora (a reload
    without a source keeps the current step); returns (servers,
    shard_addrs)."""
    current = {"step": min(corpora)}

    def loader(source):
        step = (source or {}).get("step") or current["step"]
        current["step"] = step
        return corpora[step]

    servers, shard_addrs = [], []
    for part in range(num_parts):
        reps = []
        for _ in range(replicas):
            srv = server_cls(loader=loader, part=part, num_parts=num_parts,
                             warm_k=8, **kw).start()
            servers.append(srv)
            reps.append((srv.host, srv.port))
        shard_addrs.append(reps)
    return servers, shard_addrs


def _fleet(server_cls, corpora, num_parts, replicas, **kw):
    servers = []
    try:
        servers, shard_addrs = _boot(server_cls, corpora, num_parts, replicas, **kw)
        yield servers, shard_addrs
    finally:
        for s in servers:
            s.stop()


def _corpora(cls, data):
    return {s: cls.build(data["ids"], t, attrs=data["attrs"], step=s)
            for s, t in data["tables"].items()}


@pytest.fixture(scope="module")
def fleet(data):
    """The port's 2-shard x 2-replica fleet over two versions."""
    yield from _fleet(lambda **kw: RetrievalServer(device="cpu", **kw),
                      _corpora(EmbeddingCorpus, data), 2, 2)


@pytest.fixture(scope="module")
def jax_fleet(data):
    """The JAX package's 2-shard x 1-replica fleet over the same data."""
    yield from _fleet(JaxRetrievalServer, _corpora(JaxEmbeddingCorpus, data), 2, 1)


@pytest.fixture(scope="module")
def pair_fleet(data):
    """One shard on two port replicas: the hedging tests' fleet."""
    yield from _fleet(lambda **kw: RetrievalServer(device="cpu", **kw),
                      {1: EmbeddingCorpus.build(data["ids"], data["tables"][1])}, 1, 2)


def _at_step(client, servers, step):
    """Roll every replica to `step` unless all of them serve it already;
    returns the reload reports (None when nothing was rolled)."""
    if all(s._engine.corpus.version.startswith(f"v{step:012d}-") for s in servers):
        return None
    reports = client.reload_all(source={"step": step})
    assert all("error" not in r for r in reports.values()), reports
    return reports


def _version(servers):
    versions = {s._engine.corpus.version for s in servers}
    assert len(versions) == 1
    return versions.pop()


# ---------------------------------------------------------------------------
# verb tables, stats, reports
# ---------------------------------------------------------------------------


def test_verb_tables_match_the_reference():
    assert client_mod.WIRE_VERBS == RetrievalServer.HANDLED_VERBS
    assert RetrievalClient.WIRE_VERBS == client_mod.WIRE_VERBS
    assert client_mod.WIRE_VERBS == jax_client_mod.WIRE_VERBS
    assert RetrievalServer.HANDLED_VERBS == JaxRetrievalServer.HANDLED_VERBS
    assert RetrievalRouter.MAX_VERSION_ROUNDS == 4


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
def test_fleet_bit_parity_and_stats_match_jax(fleet, jax_fleet, data, filtered):
    servers, shard_addrs = fleet
    cli = RetrievalClient(shard_addrs)
    jcli = JaxRetrievalClient(jax_fleet[1])
    try:
        _at_step(cli, servers, 1)
        _at_step(jcli, jax_fleet[0], 1)
        dnf, mask = (DNF, data["mask"]) if filtered else (None, None)
        got = cli.retrieve(data["q"], 9, dnf=dnf)
        _same(got, numpy_topk_oracle(data["ids"], data["tables"][1], data["q"], 9,
                                     mask=mask))
        st, jst = cli.corpus_stats(), jcli.corpus_stats()
        assert set(st) == set(jst) == {"0", "1"}
        for s, js in zip(st.values(), jst.values()):
            assert set(s) == set(js)
            assert {k: s[k] for k in ("rows", "version", "dim", "shard")} == {
                k: js[k] for k in ("rows", "version", "dim", "shard")}
        assert sum(s["rows"] for s in st.values()) == N
        assert {s["version"] for s in st.values()} == {_version(servers)}
        fleet_st, jfleet_st = cli.fleet_stats(), jcli.fleet_stats()
        assert len(fleet_st) == 4 and len(jfleet_st) == 2
        assert {frozenset(s) for s in fleet_st.values()} == {
            frozenset(s) for s in jfleet_st.values()}
        assert all(p is True for p in cli.ping_all().values())
        assert set(cli.router.stats()) == set(jcli.router.stats())
    finally:
        cli.close()
        jcli.close()


REPORT_KEYS = {"from_version", "to_version", "rows", "build_s", "swapped", "canary_n",
               "canary_parity"}


@pytest.mark.parametrize("direction", ["jax_client-port_servers", "port_client-jax_servers"])
def test_answers_and_reload_reports_cross_the_wire(fleet, jax_fleet, data, direction):
    """Either package's client is answered by the other's fleet with the
    oracle's bits, filtered and unfiltered, before and after a hot swap,
    and the reload reports carry the reference's keys; a reload to the
    version a port server already serves keeps canary parity."""
    servers, shard_addrs = fleet if direction == "jax_client-port_servers" else jax_fleet
    if direction == "jax_client-port_servers":
        cli, same = JaxRetrievalClient(shard_addrs), RetrievalClient(shard_addrs)
    else:
        cli, same = RetrievalClient(shard_addrs), JaxRetrievalClient(shard_addrs)
    q, ids = data["q"], data["ids"]
    try:
        _at_step(cli, servers, 1)
        for step in (1, 2):
            for dnf, mask in ((None, None), (DNF, data["mask"])):
                want = numpy_topk_oracle(ids, data["tables"][step], q, 7, mask=mask)
                _same(cli.retrieve(q, 7, dnf=dnf), want)
                _same(same.retrieve(q, 7, dnf=dnf), want)
            if step == 1:
                reports = cli.reload_all(source={"step": 2}, canary_q=q[:2], canary_k=3)
        assert {frozenset(r) for r in reports.values()} == {frozenset(REPORT_KEYS)}
        assert all(r["swapped"] and r["canary_parity"] is False for r in reports.values())
        if direction == "jax_client-port_servers":
            again = cli.reload_all(source={"step": 2}, canary_q=q[:2], canary_k=3)
            assert {frozenset(r) for r in again.values()} == {frozenset(REPORT_KEYS)}
            assert all(not r["swapped"] and r["canary_parity"] for r in again.values())
    finally:
        cli.close()
        same.close()


def test_swap_report_keys_match_jax(tmp_path):
    """The real runtimes' `swap` reports: the keys of JAX's report, no
    more (a ModelServer sends the report as its `reload` reply)."""
    jgraph = jax_random_graph(num_nodes=40, out_degree=3, feat_dim=4, seed=2)
    graph = random_graph(num_nodes=40, out_degree=3, feat_dim=4, seed=2)
    jflow = JaxSageDataFlow(jgraph, ["feat"], fanouts=[2], label_feature="label",
                            rng=np.random.default_rng(0))
    flow = SageDataFlow(graph, ["feat"], fanouts=[2], label_feature="label",
                        rng=np.random.default_rng(0))
    rng = np.random.default_rng(0)

    def dense(i, o):
        return {"kernel": rng.normal(0, i**-0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    params = {"params": {"net": {"gnn": {"convs_0": {"Dense_0": dense(8, 4)}}},
                         "out": dense(4, 2)}}
    jmodel = JaxGraphSAGE(dims=[4], label_dim=2)
    model_dir = str(tmp_path / "model")
    jrt = JaxInferenceRuntime(jmodel, jflow, model_dir, buckets=(8,), params=params)
    rt = InferenceRuntime(GraphSAGESupervised(4, [4], 2), flow, model_dir, buckets=(8,),
                          params=from_flax(params), device="cpu")
    jrep = jrt.swap(params=params, warm=False)
    rep = rt.swap(params=from_flax(params), warm=False)
    assert set(rep) == set(jrep) == {"reloaded", "reloads", "warmed_buckets", "model_dir"}
    assert rep == jrep


# ---------------------------------------------------------------------------
# the fleet under swaps, kills, hedges and tenants
# ---------------------------------------------------------------------------


def test_hot_swap_under_concurrent_load(fleet, data):
    """Queries racing a rolling reload: every answer is pinned to ONE
    version and bit-identical to THAT version's oracle — never a
    cross-version merge, never an error."""
    servers, shard_addrs = fleet
    cli = RetrievalClient(shard_addrs)
    q = data["q"][:3]
    stop = threading.Event()
    answers, errors = [], []

    def pound():
        while not stop.is_set():
            try:
                answers.append(cli.router.retrieve(q, 6))
            except Exception as e:  # any leak fails the test below
                errors.append(e)

    def wait_for(pred):
        deadline = time.monotonic() + JOIN_S
        while not pred() and not errors and time.monotonic() < deadline:
            time.sleep(0.01)

    threads = [threading.Thread(target=pound, daemon=True) for _ in range(3)]
    try:
        _at_step(cli, servers, 1)
        v1 = _version(servers)
        for t in threads:
            t.start()
        wait_for(lambda: len(answers) >= 6)
        reports = _at_step(cli, servers, 2)  # roll the fleet under load
        v2 = _version(servers)
        wait_for(lambda: sum(a[3] == v2 for a in answers[:]) >= 6)
    finally:
        stop.set()
        _join(threads)
        cli.close()
    assert not errors, errors[:3]
    assert {r["to_version"] for r in reports.values()} == {v2}
    assert all(r["swapped"] for r in reports.values())
    oracle = {v1: data["tables"][1], v2: data["tables"][2]}
    seen = set()
    for got_ids, got_sc, got_va, ver in answers:
        seen.add(ver)
        _same((got_ids, got_sc, got_va),
              numpy_topk_oracle(data["ids"], oracle[ver], q, 6))
    assert seen == {v1, v2}, "load never straddled the swap"


def test_version_pinning_and_skew_error(fleet, data):
    """After a swap the outgoing engine stays queryable as _prev (the
    router's min-version pin path); an unknown pin answers the typed
    'corpus version skew' verdict, not garbage."""
    servers, shard_addrs = fleet
    cli = RetrievalClient(shard_addrs)
    rep = _Replica(*shard_addrs[0][0], shard=0)
    try:
        _at_step(cli, servers, 1)
        v1 = _version(servers)
        _at_step(cli, servers, 2)
        v2 = _version(servers)
        assert v1 < v2  # lexicographic == step order
        q = data["q"][:2]
        out = rep.call("retrieve", [q, 3, None, None, v1], timeout_s=5.0)
        assert out[3] == v1  # served from _prev, version echoed
        shard0 = servers[0]._prev.corpus
        _same([np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2]) != 0],
              numpy_topk_oracle(shard0.ids, data["tables"][1][np.searchsorted(
                  data["ids"], shard0.ids)], q, 3))
        with pytest.raises(RpcError, match="corpus version skew"):
            rep.call("retrieve", [q, 3, None, None, "v999999999999-deadbeef"],
                     timeout_s=5.0)
    finally:
        rep.drop()
        cli.close()


def test_replica_kill_failover_bit_identical(fleet, data):
    """One replica per shard drops dead mid-run (seeded chaos reset):
    every query still answers, bit-identical to the fault-free oracle,
    with no typed-error leak — pure transport failover."""
    servers, shard_addrs = fleet
    cli = RetrievalClient(shard_addrs)
    try:
        _at_step(cli, servers, 1)
        want = numpy_topk_oracle(data["ids"], data["tables"][1], data["q"], 8)
        plan = FaultPlan(
            [Fault(site="client", kind="reset", shard=s, replica=shard_addrs[s][0], after=1)
             for s in range(2)],
            seed=11,
        )
        chaos.install(plan)
        try:
            for _ in range(6):
                _same(cli.retrieve(data["q"], 8), want)
        finally:
            chaos.uninstall()
        assert sum(sh.retry_count for sh in cli.shards) > 0  # real failovers
    finally:
        cli.close()


def test_hedged_query_stays_bitwise(pair_fleet, data):
    """A slow replica trips the hedge; the answer is the bits the fast
    path gives (replicas serve the same shard corpus)."""
    _, shard_addrs = pair_fleet
    cli = RetrievalClient(shard_addrs, hedge_ms=40.0)
    chaos.install(FaultPlan(
        [Fault(site="client", kind="delay", delay_s=0.4, replica=shard_addrs[0][0],
               op="retrieve")], seed=3))
    try:
        q = data["q"][:2]
        _same(cli.retrieve(q, 5), numpy_topk_oracle(data["ids"], data["tables"][1], q, 5))
        assert cli.router.hedges >= 1
    finally:
        chaos.uninstall()
        cli.close()


def test_concurrent_hedged_queries_never_deadlock(fleet, data):
    """Primary and hedge run on each shard's own executor (leaf tasks),
    never the router's pool: concurrent hedged queries always drain,
    answers bitwise."""
    servers, shard_addrs = fleet
    cli = RetrievalClient(shard_addrs, hedge_ms=5.0)
    try:
        _at_step(cli, servers, 1)
        q = data["q"][:2]
        want = numpy_topk_oracle(data["ids"], data["tables"][1], q, 5)
        results, errors = [], []

        def worker():
            try:
                results.append(cli.retrieve(q, 5))
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(6)]
        for t in threads:
            t.start()
        _join(threads)
        assert not errors and len(results) == 6
        for got in results:
            _same(got, want)
    finally:
        cli.close()


def test_hedge_budget_refills_on_unhedged_success(pair_fleet, data):
    """Un-hedged successes refill the hedge bucket, so a fleet that
    answers in time again earns its hedges back."""
    _, shard_addrs = pair_fleet
    cli = RetrievalClient(shard_addrs, hedge_ms=250.0, hedge_budget=1.0)
    # every replica slow: whichever the primary pins, the hedge window
    # elapses and the single token is spent
    slow = FaultPlan([Fault(site="client", kind="delay", delay_s=0.6, op="retrieve")],
                     seed=3)
    q = data["q"][:1]
    budget = cli.router._hedge_budget
    try:
        chaos.install(slow)
        try:
            cli.retrieve(q, 3)
        finally:
            chaos.uninstall()
        assert cli.router.hedges == 1
        assert budget.tokens < 1.0
        for _ in range(64):
            cli.retrieve(q, 3)
            if budget.tokens >= 1.0:
                break
        assert budget.tokens >= 1.0
        assert cli.router.hedges == 1  # refill spent nothing
        chaos.install(slow)
        try:
            cli.retrieve(q, 3)
        finally:
            chaos.uninstall()
        assert cli.router.hedges == 2  # the refilled token bought a hedge
    finally:
        cli.close()


@pytest.fixture(scope="module")
def quota_fleet(data):
    """One port server whose tenants get one admit, then run dry."""
    corpus = EmbeddingCorpus.build(data["ids"][:40], data["tables"][1][:40, :6])
    yield from _fleet(lambda **kw: RetrievalServer(device="cpu", **kw), {1: corpus}, 1, 1,
                      tenant_quota=TenantQuota(qps=0.001, burst=1.0))


@pytest.mark.parametrize("client_cls", [RetrievalClient, JaxRetrievalClient],
                         ids=["port_client", "jax_client"])
def test_tenant_quota_overload_is_typed(quota_fleet, client_cls, data):
    """A flooding tenant gets ITS typed OverloadError (never transport-
    retried), in either package's client; anonymous traffic and other
    tenants are untouched."""
    _, shard_addrs = quota_fleet
    cli = client_cls(shard_addrs)
    # the fleet's quota outlives a case: each case brings its own tenants
    flood, calm = (f"{name}-{client_cls.__module__}" for name in ("flood", "calm"))
    q = np.random.default_rng(1).standard_normal((1, 6)).astype(np.float32)
    try:
        got = cli.retrieve(q, 3, tenant=flood)  # spends the only token
        overload = OverloadError if client_cls is RetrievalClient else JaxOverloadError
        with pytest.raises(overload, match=flood):
            cli.retrieve(q, 3, tenant=flood)
        for tenant in (None, calm):
            _same(cli.retrieve(q, 3, tenant=tenant), got)
    finally:
        cli.close()


def test_hedge_decision_and_target_share_one_rotation_snapshot():
    """The COW replica tuple is read exactly ONCE per call, so the
    hedge-or-not decision and the hedge-target pick cannot observe two
    different rotations when the replica set is swapped mid-call."""

    class _Rep:
        def __init__(self, host, port):
            self.host, self.port = host, port

    class _RotatingShard:
        def __init__(self):
            self._reps = (_Rep("a", 1), _Rep("b", 2))
            self.replica_reads = 0
            self.prefers = []

        @property
        def replicas(self):
            # every read observes a DIFFERENT rotation
            self.replica_reads += 1
            self._reps = tuple(reversed(self._reps))
            return self._reps

        def _pick(self):
            return self._reps[0]

        def submit(self, verb, values, deadline_s=None, prefer=None):
            self.prefers.append(prefer)
            fut = concurrent.futures.Future()
            if len(self.prefers) > 1:  # the hedge answers immediately
                fut.set_result(("ids", "scores", "valid", "v1"))
            return fut  # the primary never completes

    router = RetrievalRouter([], hedge_ms=1.0)
    sh = _RotatingShard()
    try:
        out = router._shard_retrieve(sh, ["q"], None)
    finally:
        router.close()
    assert out == ("ids", "scores", "valid", "v1")
    assert sh.replica_reads == 1
    assert len(sh.prefers) == 2 and sh.prefers[0] != sh.prefers[1]


# ---------------------------------------------------------------------------
# tools/retrieve.py
# ---------------------------------------------------------------------------


def _parser_of(main) -> argparse.ArgumentParser:
    """The parser `main` builds, caught at its parse_args call."""
    caught = []

    class _Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught.append(self)
        raise _Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Caught):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught[0]


def test_cli_flags_are_the_reference_s_plus_device():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default) for a in parser._actions}

    jax_flags = flags(_parser_of(jax_retrieve_tool.main))
    port_flags = flags(_parser_of(retrieve_tool.main))
    assert port_flags.pop("device") == (("--device",), "cuda")
    assert port_flags == jax_flags
    assert _parser_of(retrieve_tool.main).parse_args(["--impl", "ref"]).impl == "ref"


def test_selftest_on_cpu(capsys):
    assert retrieve_tool.main(["--selftest", "--device", "cpu", "--seed", "1"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["selftest"] == "ok" and summary["device"] == "cpu"
    assert summary["unfiltered_parity"] and summary["filtered_parity"]
    assert summary["hot_swap"] and summary["post_swap_parity"]
