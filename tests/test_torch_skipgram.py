"""The port's skip-gram family against the JAX package: the metrics
(within 1e-6), `gen_pair`, the random walk (numpy store on 1 and 2
shards, unbiased and node2vec-biased, and the native engine) and edge
draws bitwise, `deepwalk_batches` / `line_batches` bitwise from one graph
directory and one seed, `Embedding` and `SkipGramModel` (loss, metric
and grads within 1e-5 on `from_flax` params), `DeviceWalkFlow` and
`DeviceEdgeFlow` fed JAX's draws bitwise (the biased walk bitwise where
its f32 partial sums are exact: unit weights, p and q powers of two;
elsewhere a stated rule and the fraction it covers), and a few
Estimator steps of DeepWalk (host source) and LINE (device flow) within
1e-4 of JAX's losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
from euler_tpu.dataflow import DeviceEdgeFlow as JaxDeviceEdgeFlow
from euler_tpu.dataflow import DeviceWalkFlow as JaxDeviceWalkFlow
from euler_tpu.dataflow.walk import gen_pair as jax_gen_pair
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import SkipGramModel as JaxSkipGram
from euler_tpu.models import deepwalk_batches as jax_deepwalk_batches
from euler_tpu.models import line_batches as jax_line_batches
from euler_tpu.nn import metrics as jax_metrics
from euler_tpu.nn.encoders import Embedding as JaxEmbedding
from euler_tpu_torch.dataflow import DeviceEdgeFlow, DeviceWalkFlow, gen_pair
from euler_tpu_torch.estimator import Estimator, EstimatorConfig, stack_batches
from euler_tpu_torch.graph import Graph, convert_json, native
from euler_tpu_torch.models import SkipGramModel, deepwalk_batches, line_batches
from euler_tpu_torch.nn import Embedding, metrics
from euler_tpu_torch.params import checkpoint_order, from_flax, to_flax_leaf

torch.set_num_threads(1)

N_NODES = 90


def graph_json(n=N_NODES, unit=False, seed=0, max_deg=9):
    """Ring plus random chords: degrees 1..max_deg, varying node weights
    (so roots and negatives go through the node CDFs), unit or varying
    edge weights."""
    rng = np.random.default_rng(seed)
    nodes = [{"id": i, "type": 0, "weight": 1.0 + i % 4,
              "features": [{"name": "feature", "type": "dense",
                            "value": [float(i % 5), 1.0, float(i % 3)]}]}
             for i in range(1, n + 1)]
    edges = []
    for i in range(1, n + 1):
        dsts = {i % n + 1} | {int(d) for d in rng.integers(1, n + 1, rng.integers(0, max_deg))}
        for d in sorted(dsts):
            w = 1.0 if unit else float(1 + (i * d) % 3)
            edges.append({"src": i, "dst": d, "type": i % 2, "weight": w, "features": []})
    return {"nodes": nodes, "edges": edges}


@pytest.fixture(scope="module")
def graphs():
    """(jax graph, port graph) per edge-weight kind and shard count."""
    out = {}
    for unit in (False, True):
        for parts in (1, 2):
            j = graph_json(unit=unit)
            out[unit, parts] = (JaxGraph.from_json(j, parts), Graph.from_json(j, parts))
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


def _same_dict(want, got):
    assert sorted(want) == sorted(got)  # a jitted JAX dict comes back key-sorted
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        _same(np.asarray(want[k]), g)


# ---- metrics -------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4, 40).astype(np.float32)
    neg = rng.integers(0, 4, (40, 7)).astype(np.float32)  # many ties
    labels = (rng.random(50) > 0.5).astype(np.float32)
    scores = rng.integers(0, 5, 50).astype(np.float32)
    pairs = [
        (metrics.ranks_from_scores, jax_metrics.ranks_from_scores, (pos, neg)),
        (metrics.mrr, jax_metrics.mrr, (pos, neg)),
        (metrics.mean_rank, jax_metrics.mean_rank, (pos, neg)),
        (lambda a, b: metrics.hit_at_k(a, b, 2), lambda a, b: jax_metrics.hit_at_k(a, b, 2),
         (pos, neg)),
        (metrics.auc, jax_metrics.auc, (labels, scores)),
        (metrics.accuracy, jax_metrics.accuracy, (labels, scores > 2)),
        (metrics.micro_f1, jax_metrics.micro_f1, (labels, scores - 2)),
    ]
    for port, ref, args in pairs:
        want = np.asarray(jax.jit(ref)(*(jnp.asarray(a) for a in args)))
        got = port(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert sorted(metrics.METRICS) == sorted(jax_metrics.METRICS)


def test_embedding_matches_jax():
    """Rows padded to a 128 multiple, out-of-range ids clipped (padding
    -1 reads row 0), forward and table grads within 1e-5."""
    rng = np.random.default_rng(1)
    ids = np.array([[-1, 0, 3], [199, 200, 5000]], np.int32)
    g = rng.normal(size=(2, 3, 6)).astype(np.float32)
    jm = JaxEmbedding(200, 6)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x), jax.tree_util.tree_map(
        lambda x: x.unbox() if hasattr(x, "unbox") else x, tree,
        is_leaf=lambda x: hasattr(x, "unbox")))
    want, vjp = jax.vjp(lambda p: jm.apply(p, jnp.asarray(ids)), tree)
    (jgrad,) = vjp(jnp.asarray(g))
    pm = Embedding(200, 6)
    assert tuple(pm.table.shape) == (256, 6)
    pm.load_state_dict(from_flax(tree))
    got = pm(torch.from_numpy(ids))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.table.grad.numpy(), np.asarray(jgrad["params"]["table"]),
                               rtol=1e-5, atol=1e-5)


# ---- host sources --------------------------------------------------------


def test_gen_pair_matches_jax():
    rng = np.random.default_rng(2)
    walks = rng.integers(0, 50, (6, 5)).astype(np.uint64)
    walks[1, 3:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    for lw, rw in ((1, 1), (2, 2), (0, 3)):
        want, got = jax_gen_pair(walks, lw, rw), gen_pair(walks, lw, rw)
        _same(want[0], got[0])
        _same(want[1], got[1])


@pytest.mark.parametrize("unit,parts", [(False, 1), (True, 1), (False, 2)])
def test_walks_and_edge_draws_match_jax(graphs, unit, parts):
    jg, pg = graphs[unit, parts]
    ids = np.arange(1, N_NODES + 12, 3, dtype=np.uint64)  # some unknown
    for p, q in ((1.0, 1.0), (0.5, 2.0), (2.0, 0.25)):
        _same(jg.random_walk(ids, None, 4, p, q, rng=np.random.default_rng(3)),
              pg.random_walk(ids, None, 4, p, q, rng=np.random.default_rng(3)))
    _same(jg.random_walk(ids, [1], 3, rng=np.random.default_rng(4)),
          pg.random_walk(ids, [1], 3, rng=np.random.default_rng(4)))
    for et in (-1, 0, 1):
        _same(jg.sample_edge(37, et, rng=np.random.default_rng(5)),
              pg.sample_edge(37, et, rng=np.random.default_rng(5)))
    js, ps = jg.shards[0], pg.shards[0]
    rows, targets = np.arange(ps.num_nodes) % 7, ps.node_ids[::-1].copy()
    for t in range(2):
        _same(js.adj[t].contains(rows, targets), ps.adj[t].contains(rows, targets))


@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("skipgram"))
    convert_json(graph_json(), d, 1)
    return d


def test_batch_sources_match_jax(graph_dir):
    """deepwalk (unbiased and node2vec) and LINE batches from one graph
    dir and one seed: bitwise, numpy stores."""
    jg, pg = JaxGraph.load(graph_dir, native=False), Graph.load(graph_dir, native=False)
    for kw in ({}, {"p": 0.5, "q": 2.0}):
        jf = jax_deepwalk_batches(jg, 8, 3, 2, 4, rng=np.random.default_rng(6), **kw)
        pf = deepwalk_batches(pg, 8, 3, 2, 4, rng=np.random.default_rng(6), **kw)
        for _ in range(2):
            _same_dict(jf()[0], pf()[0])
    jf = jax_line_batches(jg, 16, 3, rng=np.random.default_rng(7))
    pf = line_batches(pg, 16, 3, rng=np.random.default_rng(7))
    for _ in range(2):
        _same_dict(jf()[0], pf()[0])


def test_native_walk_and_edges_match_jax_binding(graph_dir, monkeypatch):
    """The engine's random walk (node2vec to the numpy path) and edge
    draws through both bindings of one library, in one process."""
    path = native.build_engine()
    monkeypatch.setattr(jax_native, "build_engine", lambda force=False: path)
    monkeypatch.setattr(jax_native, "_lib", None)
    jg, pg = JaxGraph.load(graph_dir, native=True), Graph.load(graph_dir, native=True)
    assert type(pg.shards[0]).__name__ == "NativeGraphStore"
    ids = np.arange(1, N_NODES + 5, 2, dtype=np.uint64)
    for p, q in ((1.0, 1.0), (0.5, 2.0)):
        _same(jg.random_walk(ids, None, 5, p, q, rng=np.random.default_rng(8)),
              pg.random_walk(ids, None, 5, p, q, rng=np.random.default_rng(8)))
    _same(jg.sample_edge(50, rng=np.random.default_rng(9)),
          pg.sample_edge(50, rng=np.random.default_rng(9)))
    _same_dict(jax_deepwalk_batches(jg, 8, 3, 1, 2, rng=np.random.default_rng(1))()[0],
               deepwalk_batches(pg, 8, 3, 1, 2, rng=np.random.default_rng(1))()[0])


# ---- the model -----------------------------------------------------------


def _batch(rng, b=12, n=4, num_nodes=N_NODES):
    return {"src": rng.integers(-1, num_nodes + 1, b).astype(np.int32),
            "pos": rng.integers(1, num_nodes + 1, b).astype(np.int32),
            "negs": rng.integers(1, num_nodes + 1, (b, n)).astype(np.int32),
            "mask": rng.random(b) > 0.2}


def _tree(model, batch, seed=0):
    """A flax init of `model` as numpy leaves, scaled so the logits are
    not all near zero."""
    tree = jax.jit(model.init)(jax.random.PRNGKey(seed),
                               jax.tree_util.tree_map(jnp.asarray, batch))
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x),
                                  tree, is_leaf=lambda x: hasattr(x, "unbox"))
    return jax.tree_util.tree_map(lambda x: x * 20.0, tree)


@pytest.mark.parametrize("shared", [False, True])
def test_skipgram_loss_metric_and_grads_match_jax(shared):
    batch = _batch(np.random.default_rng(10))
    jm = JaxSkipGram(num_nodes=N_NODES, dim=8, shared_context=shared)
    tree = _tree(jm, batch)

    def loss_fn(p):
        _, loss, _, metric = jm.apply(p, jax.tree_util.tree_map(jnp.asarray, batch))
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm = SkipGramModel(num_nodes=N_NODES, dim=8, shared_context=shared)
    pm.load_state_dict(from_flax(tree))
    _, loss, name, metric = pm({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert name == "mrr"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metric.item(), float(jmetric), rtol=1e-5, atol=1e-5)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) == (1 if shared else 2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# ---- device flows fed JAX's draws ----------------------------------------


def walk_draws(jf, key):
    """The random numbers JAX's DeviceWalkFlow.sample(key) draws
    (device.py:1231-1244), as the port's draw_inputs returns them."""
    kroot, kneg, kwalk = jax.random.split(key, 3)
    roots = np.asarray(jf._draw_roots(kroot, jf.batch_size))
    steps = []
    for sk in jax.random.split(kwalk, jf.walk_len):
        if jf.biased or jf.unit_w:
            d = np.asarray(jax.random.uniform(sk, (jf.batch_size, 1)))
        else:
            d = np.asarray(jax.random.bits(sk, (jf.batch_size, 1), dtype=jnp.uint32)).view(np.int32)
        steps.append(torch.from_numpy(d.copy()))
    negs = np.asarray(jf._draw_roots(kneg, jf.batch_size * jf.pairs_per_walk * jf.num_negs))
    return torch.from_numpy(roots.copy()), tuple(steps), torch.from_numpy(negs.copy())


def edge_draws(jf, key, count):
    """JAX's `_FlatEdgeFlow` draws: edge picks, then `count` global rows."""
    kedge, kneg = jax.random.split(key)
    pick = np.asarray(jf._draw_edges(kedge, jf.batch_size)).astype(np.int64)
    negs = np.asarray(jf._draw_global_nodes(kneg, count))
    return torch.from_numpy(pick), torch.from_numpy(negs.copy())


def _same_tables(jf, pf, names):
    for name in names:
        a, b = getattr(jf, name), getattr(pf, name)
        assert (a is None) == (b is None), name
        if a is not None:
            want, got = np.asarray(a), b.numpy()
            if want.dtype == np.uint32:
                want = want.astype(np.int64)
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("unit,p,q", [(False, 1.0, 1.0), (True, 1.0, 1.0), (True, 0.5, 2.0),
                                      (True, 2.0, 0.25)])
def test_walk_flow_matches_jax(graphs, unit, p, q):
    jg, pg = graphs[unit, 1]
    kw = dict(batch_size=10, walk_len=4, window=2, num_negs=3, p=p, q=q)
    jf, pf = JaxDeviceWalkFlow(jg, **kw), DeviceWalkFlow(pg, **kw, device="cpu")
    assert (jf.biased, jf.unit_w, jf.max_deg, jf.pairs_per_walk) == (
        pf.biased, pf.unit_w, pf.max_deg, pf.pairs_per_walk)
    _same_tables(jf, pf, ["adj", "deg", "node_id", "node_cdf", "global_cdf"])
    sample = jax.jit(jf.sample)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        _same_dict(sample(key), pf.make_batch(*walk_draws(jf, key)))


def test_biased_walk_on_weighted_edges_matches_jax_off_the_partial_sums(graphs):
    """Weighted edges and p, q not powers of two: the f32 cumsum of the
    biased weights may round differently in XLA's and torch's scans, so a
    step is held where the scaled uniform lies farther than 4 ulp of the
    row total from every f64 partial sum; the test states the fraction
    of steps that rule covers (measured 1.0 on this graph)."""
    jg, pg = graphs[False, 1]
    kw = dict(batch_size=200, walk_len=1, window=1, num_negs=1, p=0.3, q=3.0)
    jf, pf = JaxDeviceWalkFlow(jg, **kw), DeviceWalkFlow(pg, **kw, device="cpu")
    rng = np.random.default_rng(11)
    cur = torch.from_numpy(rng.integers(1, N_NODES + 1, 200).astype(np.int32))
    prev = torch.from_numpy(rng.integers(0, N_NODES + 1, 200).astype(np.int32))
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (200, 1)))
    want = np.asarray(jax.jit(jf._walk_step)(jnp.asarray(cur.numpy()),
                                             jnp.asarray(prev.numpy()), key))
    got = pf._walk_step(cur, prev, torch.from_numpy(u.copy())).numpy()
    # the biased weights, as both compute them, and their exact sums
    nbr = pf.adj[cur].numpy()
    prev_nbrs = pf.adj[prev].numpy()
    near = ((nbr[:, :, None] == prev_nbrs[:, None, :]) & (prev_nbrs[:, None, :] > 0)).any(-1)
    bias = np.where(nbr == prev.numpy()[:, None], np.float32(1 / 0.3),
                    np.where(near, np.float32(1.0), np.float32(1 / 3.0)))
    bias = np.where((prev.numpy() > 0)[:, None], bias, np.float32(1.0))
    bw = (pf.wtab[cur].numpy() * bias * (nbr > 0)).astype(np.float64)
    cum = np.cumsum(bw, axis=1)
    tot = cum[:, -1]
    margin = 4 * np.spacing(tot.astype(np.float32)).astype(np.float64)
    safe = (np.abs(u * tot[:, None] - cum) > margin[:, None]).all(axis=1)
    assert safe.mean() >= 0.95, safe.mean()
    np.testing.assert_array_equal(got[safe], want[safe])


@pytest.mark.parametrize("unit", [False, True])
def test_edge_flow_matches_jax(graphs, unit):
    jg, pg = graphs[unit, 2]
    jf, pf = JaxDeviceEdgeFlow(jg, 16, 3), DeviceEdgeFlow(pg, 16, 3, device="cpu")
    _same_tables(jf, pf, ["eh", "et", "node_id", "node_cdf", "global_cdf", "edge_cdf"])
    assert jf.num_edges == pf.num_edges and pf.er is None
    sample = jax.jit(jf.sample)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        _same_dict(sample(key), pf.make_batch(*edge_draws(jf, key, 16 * 3)))
    with pytest.raises(NotImplementedError, match="item 6"):
        DeviceEdgeFlow(pg, 16, 3, mesh=object(), device="cpu")


def test_port_draws_follow_the_weights(graphs):
    """The port's own generator: edge picks and negatives land on staged
    entries, LINE's batch ids are real ids, walks move along edges."""
    jg, pg = graphs[False, 1]
    ef = DeviceEdgeFlow(pg, 512, 2, device="cpu")
    b = ef.sample(torch.Generator().manual_seed(0))
    edges = {(int(s), int(d)) for s, d in zip(pg.shards[0].edge_src, pg.shards[0].edge_dst)}
    assert all((int(s), int(d)) in edges for s, d in zip(b["src"], b["pos"]))
    assert int(b["negs"].min()) >= 1 and int(b["negs"].max()) <= N_NODES
    wf = DeviceWalkFlow(pg, 64, walk_len=3, window=1, num_negs=2, p=0.5, q=2.0, device="cpu")
    w = wf.sample(torch.Generator().manual_seed(1))
    m = w["mask"].numpy()
    pairs = {(int(s), int(d)) for s, d in zip(w["src"].numpy()[m], w["pos"].numpy()[m])}
    assert pairs and all((s, d) in edges or (d, s) in edges for s, d in pairs)


# ---- Estimator steps -----------------------------------------------------


CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)


def test_deepwalk_estimator_matches_jax(graphs, tmp_path):
    """4 adam steps on the same host batches from the same flax init, the
    port at steps_per_call 1 and 2."""
    jg, pg = graphs[False, 1]
    src = jax_deepwalk_batches(jg, 8, 3, 1, 4, rng=np.random.default_rng(12))
    batches = [src() for _ in range(5)]  # one more: JAX initialises from a draw
    jm = JaxSkipGram(num_nodes=N_NODES, dim=8)
    tree = _tree(jm, batches[0][0], seed=1)
    jit = iter(batches)
    jest = JaxEstimator(jm, lambda: next(jit), JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(4, log=False, save=False))
    for k in (1, 2):  # K = 2: dict batches stacked by `stack_batches`
        pit = iter(batches)
        fn = (lambda: next(pit)) if k == 1 else stack_batches(lambda: next(pit), 2)
        pest = Estimator(SkipGramModel(N_NODES, 8), fn,
                         EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                         **CFG),
                         init_params=from_flax(tree), device="cpu")
        pl = np.asarray(pest.train(4, log=False, save=False))
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


def test_line_device_flow_estimator_matches_jax(graphs, tmp_path):
    """LINE on DeviceEdgeFlow: 3 adam steps of JAX's `_train_scan` at
    steps_per_call 2, and the port fed JAX's per-step draws (fold_in of
    the flow key per global step) at steps_per_call 1 and 2 (on the CPU a
    call's steps run eagerly): losses within 1e-4. (The unsupervised
    family's test holds JAX's K = 1 step; this one its scan.)"""
    jg, pg = graphs[False, 1]
    jf, pf = JaxDeviceEdgeFlow(jg, 16, 3), DeviceEdgeFlow(pg, 16, 3, device="cpu")
    jm = JaxSkipGram(num_nodes=N_NODES, dim=8, shared_context=True)
    tree = _tree(jm, _batch(np.random.default_rng(0), 16, 3), seed=2)
    jest = JaxEstimator(jm, jf, JaxConfig(model_dir=str(tmp_path / "j"), steps_per_call=2, **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    flow_key = jax.random.PRNGKey(CFG["seed"] + 2)
    draws = [edge_draws(jf, jax.random.fold_in(flow_key, s), 16 * 3) for s in range(3)]
    for k in (1, 2):
        it = iter(draws)
        pf.draw_inputs = lambda gen: next(it)
        pest = Estimator(SkipGramModel(N_NODES, 8, shared_context=True), pf,
                         EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                         **CFG),
                         init_params=from_flax(tree), device="cpu")
        pl = np.asarray(pest.train(3, log=False, save=False))
        del pf.draw_inputs
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
