"""euler_tpu_torch InferenceRuntime against the JAX package's: the port
restores a checkpoint written by the JAX CheckpointStore, the JAX runtime
serves the same flax params, and both answer the same requests — in
process, and over TCP through each package's ModelServer."""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullNeighborDataFlow
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.estimator import EstimatorConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.serving import ModelServer as JaxModelServer
from euler_tpu.serving import ServingClient as JaxServingClient
from euler_tpu.serving.runtime import InferenceRuntime as JaxInferenceRuntime
from euler_tpu.training.checkpoint import CheckpointStore as JaxCheckpointStore
from euler_tpu_torch.dataflow import FullNeighborDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, id_batches
from euler_tpu_torch.estimator import EstimatorConfig as PortConfig
from euler_tpu_torch.distributed.registry import Registry
from euler_tpu_torch.graph import Graph, write_arrays
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import from_checkpoint_leaves, from_flax
from euler_tpu_torch.serving import InferenceRuntime, ModelServer, ServingClient
from euler_tpu_torch.tools.serve import build_parser, build_runtime, serve_fleet
from euler_tpu_torch.training import CheckpointStore, is_complete, step_of

torch.set_num_threads(1)

FEAT, DIMS, FANOUTS, BUCKETS, SEED = 12, [16, 16], [3, 2], (8, 32), 5
TOL = 1e-4
# the TCP tests: the deterministic flow, one bucket, bounded waits
MAX_DEGREE, TCP_BUCKET, JOIN_S, DEADLINE_MS = 5, 16, 30.0, 20_000.0


def _setup(tmp_path, extra=()):
    """Graph dir + a JAX-written checkpoint of flax-init params; `extra`
    flags go to the port's serve parser."""
    data, model_dir = str(tmp_path / "data"), str(tmp_path / "model")
    g = random_graph(num_nodes=300, out_degree=5, feat_dim=FEAT, seed=2)
    for p, shard in enumerate(g.shards):
        write_arrays(os.path.join(data, f"part_{p}"), shard.arrays)
    g.meta.save(data)
    jgraph = JaxGraph.load(data, native=False)
    init_flow = JaxSageDataFlow(jgraph, ["feat"], fanouts=FANOUTS,
                                label_feature="label",
                                rng=np.random.default_rng(0))
    model = JaxGraphSAGE(dims=DIMS, label_dim=2)
    params = model.init(
        jax.random.PRNGKey(0), init_flow.query(np.arange(1, 9, dtype=np.uint64))
    )
    leaves = [np.asarray(x) for x in jax.tree_util.tree_flatten(params)[0]]
    JaxCheckpointStore(model_dir).save_leaves(7, leaves, [])
    args = build_parser().parse_args([
        "--data", data, "--model-dir", model_dir, "--features", "feat",
        "--dims", ",".join(map(str, DIMS)), "--label-dim", "2",
        "--fanouts", ",".join(map(str, FANOUTS)),
        "--buckets", ",".join(map(str, BUCKETS)), "--seed", str(SEED),
        "--device", "cpu", *extra,
    ])
    return jgraph, model, params, leaves, args


def test_served_embeddings_match_jax(tmp_path):
    jgraph, model, params, _, args = _setup(tmp_path)
    jflow = JaxSageDataFlow(jgraph, ["feat"], fanouts=FANOUTS,
                            rng=np.random.default_rng(SEED))
    jrt = JaxInferenceRuntime(
        model, jflow, EstimatorConfig(model_dir=args.model_dir),
        buckets=BUCKETS, params=params,
    )
    jrt.warmup()
    prt = build_runtime(args, device="cpu")
    prt.warmup()
    assert prt._engine.step == 7
    # the JAX runtime's probe query and both warmups consumed draws
    jrt.flow.rng = np.random.default_rng(SEED)
    prt.flow.rng = np.random.default_rng(SEED)
    req = np.random.default_rng(1)
    for n in (3, 8, 20, 150):  # 150 > the top bucket: chunked
        ids = req.integers(1, 301, size=n).astype(np.uint64)
        want, got = jrt.predict(ids), prt.predict(ids)
        assert got.shape == want.shape == (n, DIMS[-1]) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert prt.device_batches == jrt.device_batches


def _ring_json(n=48, seed=0) -> dict:
    """tests/test_serving.py's ring graph: n nodes, 4-wide features, edges
    to the next three."""
    rng = np.random.default_rng(seed)
    nodes = [{"id": i + 1, "type": 0, "weight": 1.0, "features": [
        {"name": "feat", "type": "dense", "value": rng.normal(size=4).tolist()},
        {"name": "label", "type": "dense", "value": [1.0, 0.0] if i % 2 else [0.0, 1.0]},
    ]} for i in range(n)]
    edges = [{"src": i + 1, "dst": (i + d) % n + 1, "type": 0, "weight": 1.0, "features": []}
             for i in range(n) for d in (1, 2, 3)]
    return {"nodes": nodes, "edges": edges}


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
def test_runtime_serves_through_the_feature_cache(tmp_path, quant):
    """The twin of tests/test_serving.py:175-205, the production serving
    configuration (a rows-mode FullNeighborDataFlow + DeviceFeatureCache)
    for each page type: batches carry int32 rows, the runtime's program
    is its Estimator's `embed_program()`, predict is bitwise the port's
    `Estimator.infer` over the same cache and within 1e-5 of the JAX
    runtime with its cache; `swap` keeps the cache."""
    gj, ids, bucket = _ring_json(), np.arange(1, 49, dtype=np.uint64), 16
    jg, pg = JaxGraph.from_json(gj), Graph.from_json(gj)
    fkw = dict(num_hops=2, max_degree=4, label_feature="label")
    jflow = JaxFullNeighborDataFlow(jg, ["feat"], feature_mode="rows", **fkw)
    pflow = FullNeighborDataFlow(pg, ["feat"], feature_mode="rows", **fkw)
    model = JaxGraphSAGE(dims=[8, 8], label_dim=2)
    rng = np.random.default_rng(3)

    def dense(i, o):
        return {"kernel": rng.normal(0, i**-0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    params = {"params": {"net": {"gnn": {"convs_0": {"Dense_0": dense(8, 8)},
                                         "convs_1": {"Dense_0": dense(16, 8)}}},
                         "out": dense(8, 2)}}
    cache = DeviceFeatureCache(pg, ["feat"], quant=quant, device="cpu")
    prt = InferenceRuntime(GraphSAGESupervised(4, [8, 8], 2), pflow, str(tmp_path),
                           feature_cache=cache, buckets=(bucket,), params=from_flax(params),
                           device="cpu")
    assert prt._embed is prt._est.embed_program() and prt._est.feature_cache is cache
    batch, _ = pflow.query_padded(ids[:5], bucket)
    assert all(f.dtype == np.int32 and f.ndim == 1 for f in batch.feats)
    est = Estimator(GraphSAGESupervised(4, [8, 8], 2), None, PortConfig(model_dir=str(tmp_path)),
                    feature_cache=cache, init_params=from_flax(params), device="cpu")
    _, want = est.infer(*id_batches(pflow, ids, bucket))
    got = prt.predict(ids)
    np.testing.assert_array_equal(got, want)
    jrt = JaxInferenceRuntime(model, jflow, EstimatorConfig(model_dir=str(tmp_path)),
                              feature_cache=JaxFeatureCache(jg, ["feat"], quant=quant),
                              buckets=(bucket,), params=params)
    np.testing.assert_allclose(got, jrt.predict(ids), rtol=1e-5, atol=1e-5)
    prt.swap(params=from_flax(params))
    assert prt._est.feature_cache is cache
    np.testing.assert_array_equal(prt.predict(ids[:7]), want[:7])


def test_checkpoint_read_side(tmp_path):
    _, _, params, leaves, args = _setup(tmp_path)
    root = args.model_dir
    os.makedirs(os.path.join(root, "ckpt_000000000011"))  # torn: no COMMIT
    os.makedirs(os.path.join(root, "ckpt_000000000012.tmp-99"))
    store = CheckpointStore(root)
    assert store.steps() == [7] and store.latest_step() == 7
    assert step_of("ckpt_000000000040") == 40
    assert step_of("ckpt_000000000012.tmp-99") is None
    assert not is_complete(os.path.join(root, "ckpt_000000000011"))
    ckpt = store.load()
    assert ckpt["step"] == 7 and ckpt["opt_state"] == []
    for a, b in zip(ckpt["params"], leaves):
        np.testing.assert_array_equal(a, b)
    want = from_flax(params)
    got = from_checkpoint_leaves(ckpt["params"])
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "nothing")).load()
    with pytest.raises(ValueError):
        from_checkpoint_leaves(ckpt["params"][:3])


def test_runtime_swap_buckets_and_errors(tmp_path):
    _, _, params, leaves, args = _setup(tmp_path)
    rt = build_runtime(args, device="cpu")
    assert rt.buckets == BUCKETS
    assert [rt.bucket_for(n) for n in (1, 8, 9, 32, 33)] == [8, 8, 32, 32, 32]
    assert rt.poll_graph_epoch() is False
    ids = np.arange(1, 11, dtype=np.uint64)

    def predict():
        rt.flow.rng = np.random.default_rng(SEED)
        return rt.predict(ids)

    before = predict()
    doubled = {k: 2 * v for k, v in rt.params.items()}
    info = rt.swap(params=doubled)
    assert info["reloaded"] and info["reloads"] == 1
    assert info["warmed_buckets"] == list(BUCKETS)
    assert not np.allclose(predict(), before)
    # a newer complete checkpoint in model_dir is picked up on swap()
    JaxCheckpointStore(args.model_dir).save_leaves(9, leaves, [])
    rt.swap()
    assert rt._engine.step == 9
    np.testing.assert_allclose(predict(), before, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        rt.predict([])
    with pytest.raises(ValueError):
        InferenceRuntime(rt.model, rt.flow, device="cpu")
    with pytest.raises(ValueError):
        InferenceRuntime(rt.model, rt.flow, buckets=(), params=rt.params, device="cpu")
    with pytest.raises(FileNotFoundError):
        InferenceRuntime(rt.model, rt.flow, str(tmp_path / "none"), device="cpu")


def _tcp_flags():
    return ("--full-neighbor", "--max-degree", str(MAX_DEGREE),
            "--buckets", str(TCP_BUCKET))


def _hammer(clients: dict, ids_sets) -> dict:
    """Every (name, client) sends every id set from its own thread; returns
    {name: [rows per id set]}."""
    out = {name: [None] * len(ids_sets) for name in clients}

    def run(name, k):
        out[name][k] = clients[name][k].predict(ids_sets[k])

    threads = [threading.Thread(target=run, args=(name, k))
               for name in clients for k in range(len(ids_sets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    return out


def test_served_over_tcp_matches_jax_server(tmp_path):
    """The slice end to end: the JAX ModelServer over the JAX runtime and
    the port's over the port's (CPU, the same flax params), both over
    FullNeighborDataFlow with one bucket. Concurrent clients' rows agree
    within TOL, and each server's rows are its own runtime's direct
    predict, bitwise (a row does not depend on its batch)."""
    jgraph, model, params, _, args = _setup(tmp_path, _tcp_flags())
    jflow = JaxFullNeighborDataFlow(jgraph, ["feat"], num_hops=len(DIMS),
                                    max_degree=MAX_DEGREE)
    jrt = JaxInferenceRuntime(model, jflow, EstimatorConfig(model_dir=args.model_dir),
                              buckets=(TCP_BUCKET,), params=params)
    prt = build_runtime(args, params=from_flax(params))
    jrt.warmup()
    prt.warmup()
    jserver = JaxModelServer(jrt, max_wait_us=50_000).start()
    pserver = ModelServer(prt, max_wait_us=50_000).start()
    req = np.random.default_rng(2)
    ids_sets = [req.integers(1, 301, size=n).astype(np.uint64)
                for n in (1, 3, 5, 6, 8, 2, 7, 4)]
    clients = {
        "jax": [JaxServingClient((jserver.host, jserver.port), deadline_ms=DEADLINE_MS)
                for _ in ids_sets],
        "port": [ServingClient((pserver.host, pserver.port), deadline_ms=DEADLINE_MS)
                 for _ in ids_sets],
    }
    try:
        served = _hammer(clients, ids_sets)
        stats = {"jax": clients["jax"][0].stats(), "port": clients["port"][0].stats()}
    finally:
        for c in clients["jax"] + clients["port"]:
            c.close()
        jserver.stop()
        pserver.stop()
    for name in ("jax", "port"):
        assert stats[name]["requests"] == len(ids_sets)
        assert stats[name]["batches"] < len(ids_sets), stats[name]
    for ids, got, want in zip(ids_sets, served["port"], served["jax"]):
        assert got.shape == want.shape == (len(ids), DIMS[-1]) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for rt, name in ((jrt, "jax"), (prt, "port")):
        for ids, rows in zip(ids_sets, served[name]):
            np.testing.assert_array_equal(rows, np.asarray(rt.predict(ids)))


def test_serve_fleet_registers_routes_and_reloads(tmp_path):
    """`serve_fleet` as the CLI boots it: two replicas over one graph,
    heartbeating into a shared-dir registry; routed rows equal a replica's
    direct predict bitwise, and a rolling reload keeps canary parity."""
    reg = str(tmp_path / "reg")
    *_, args = _setup(tmp_path, _tcp_flags() + (
        "--replicas", "2", "--replica", "3", "--registry", reg))
    servers = serve_fleet(args)
    client = None
    try:
        addrs = [(s.host, s.port) for s in servers]
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline:
            table = Registry(reg).lookup(5)
            if table[3] and table[4]:
                break
            time.sleep(0.02)
        assert table == {0: [], 1: [], 2: [], 3: [addrs[0]], 4: [addrs[1]]}
        assert [s.runtime._engine.step for s in servers] == [7, 7]
        client = ServingClient(addrs, deadline_ms=DEADLINE_MS, routing="consistent_hash")
        ids = np.arange(1, 41, dtype=np.uint64)
        np.testing.assert_array_equal(client.predict(ids), servers[0].runtime.predict(ids))
        reports = client.reload(canary_ids=ids[:TCP_BUCKET])
        assert [r["canary_parity"] for r in reports.values()] == [True, True]
        assert [r["reloads"] for r in reports.values()] == [1, 1]
        assert [s.runtime._engine.step for s in servers] == [7, 7]
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.stop()
