"""Graph classification on the port against the JAX package:
WholeGraphDataFlow.query and graph_label_batches bitwise on the numpy and
the native store (2 partitions, so `get_graph_by_label` merges shards),
DeviceWholeGraphFlow.make_batch fed JAX's label draw bitwise, the pools
(add, mean, max, attention, set2set) forward and grads within 1e-5,
3-step GraphClassifier trainings (GIN with `add` and with `set2set`)
within 1e-5, K-stacked graph batches on both flows, and the mutag
stand-in's graph.json equal to JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
from euler_tpu.dataflow import DeviceWholeGraphFlow as JaxDeviceWholeGraphFlow
from euler_tpu.dataflow import WholeGraphDataFlow as JaxWholeFlow
from euler_tpu.dataflow import graph_label_batches as jax_graph_label_batches
from euler_tpu.datasets.quality import mutag_like_json as jax_mutag_like_json
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import GraphClassifier as JaxGraphClassifier
from euler_tpu.nn import pooling as jax_pooling
from euler_tpu_torch.dataflow import (
    DeviceWholeGraphFlow,
    GraphBatch,
    WholeGraphDataFlow,
    graph_label_batches,
)
from euler_tpu_torch.datasets import mutag_like_json
from euler_tpu_torch.estimator import Estimator, EstimatorConfig, stack_batches
from euler_tpu_torch.estimator.estimator import args_to_device
from euler_tpu_torch.graph import Graph, convert_json, native
from euler_tpu_torch.models import GraphClassifier
from euler_tpu_torch.nn import POOLS
from euler_tpu_torch.params import from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_NODES, MAX_DEGREE, BATCH = 8, 6, 4


def make_labeled_graphs(n_graphs=8, seed=0):
    """Graphs alternate between two structural/feature classes (the JAX
    package's tests/test_graph_clf.py fixture)."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    nid = 1
    for gi in range(n_graphs):
        cls = gi % 2
        size = 6
        ids = list(range(nid, nid + size))
        nid += size
        for i in ids:
            nodes.append(
                {
                    "id": i,
                    "type": 0,
                    "weight": 1.0,
                    "features": [
                        {
                            "name": "feat",
                            "type": "dense",
                            "value": rng.normal(3.0 * (1 - 2 * cls), 1.0, 4).tolist(),
                        },
                        {"name": "graph_label", "type": "binary", "value": f"g{gi}_{cls}"},
                    ],
                }
            )
        for i in ids:
            for j in ids:
                if i != j and (cls == 0 or abs(i - j) == 1):
                    edges.append(
                        {"src": i, "dst": j, "type": 0, "weight": 1.0, "features": []}
                    )
    return {"nodes": nodes, "edges": edges}


def _classed(graph_json):
    """The fixture with `_c<k>` class labels (the converter's format), so
    the flows one-hot over 2 classes rather than 8 identities."""
    out = {"nodes": [], "edges": graph_json["edges"]}
    for n in graph_json["nodes"]:
        feats = [dict(f, value=f["value"].replace("_", "_c")) if f["name"] == "graph_label"
                 else f for f in n["features"]]
        out["nodes"].append(dict(n, features=feats))
    return out


@pytest.fixture(scope="module")
def engine():
    """The port's native engine, built once; the JAX binding is pointed
    at it, so no test writes the JAX package's library."""
    path = native.build_engine()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "build_engine", lambda force=False: path)
    mp.setattr(jax_native, "_lib", None)
    yield path
    mp.undo()


@pytest.fixture(scope="module")
def graph_dirs(tmp_path_factory):
    """The fixture (identity labels) and its classed twin as graph dirs of
    2 partitions."""
    out = {}
    for name, j in (("identity", make_labeled_graphs()),
                    ("classed", _classed(make_labeled_graphs()))):
        d = str(tmp_path_factory.mktemp(name))
        convert_json(j, d, 2)
        out[name] = d
    return out


def _graphs(graph_dirs, kind, store, request):
    native_ = store == "native"
    if native_:
        request.getfixturevalue("engine")
    d = graph_dirs[kind]
    return JaxGraph.load(d, native=native_), Graph.load(d, native=native_)


def _same(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(b, a, err_msg=what)


def _same_batch(jb, pb):
    """Every leaf of a JAX GraphBatch and a port GraphBatch, bitwise."""
    assert isinstance(pb, GraphBatch) and jb.n_graphs == pb.n_graphs
    for name in ("feats", "node_mask", "graph_ids", "labels", "hop_ids"):
        _same(getattr(jb, name), getattr(pb, name), name)
    ja, pa = jb.block, pb.block
    assert (ja.n_src, ja.n_dst, ja.grid) == (pa.n_src, pa.n_dst, pa.grid)
    for name in ("edge_src", "edge_dst", "edge_w", "mask"):
        _same(getattr(ja, name), getattr(pa, name), f"block.{name}")


@pytest.mark.parametrize("store", ["numpy", "native"])
@pytest.mark.parametrize("kind", ["identity", "classed"])
def test_whole_graph_flow_matches_jax(graph_dirs, kind, store, request):
    """`query` (labels out of range, repeats, graphs cut to max_nodes) and
    `graph_label_batches` (4 draws) bitwise; the class parsing."""
    jg, pg = _graphs(graph_dirs, kind, store, request)
    for max_nodes in (MAX_NODES, 4):
        jf = JaxWholeFlow(jg, ["feat"], max_nodes=max_nodes, max_degree=MAX_DEGREE)
        pf = WholeGraphDataFlow(pg, ["feat"], max_nodes=max_nodes, max_degree=MAX_DEGREE)
        assert (pf.num_labels, pf.num_classes) == (jf.num_labels, jf.num_classes)
        np.testing.assert_array_equal(pf.label_class, jf.label_class)
        _same_batch(jf.query(np.asarray([0, 3, 3, 7, 9, -1])),
                    pf.query(np.asarray([0, 3, 3, 7, 9, -1])))
    assert pf.num_classes == (2 if kind == "classed" else 8)
    jfn = jax_graph_label_batches(jg, jf, BATCH, rng=np.random.default_rng(7))
    pfn = graph_label_batches(pg, pf, BATCH, rng=np.random.default_rng(7))
    for _ in range(4):
        (jb,), (pb,) = jfn(), pfn()
        _same_batch(jb, pb)
    for i, members in enumerate(pg.get_graph_by_label(np.arange(-1, 9))):
        _same(jg.get_graph_by_label(np.arange(-1, 9))[i], members, f"label {i - 1}")


def test_device_flow_make_batch_matches_jax(graph_dirs, request):
    """`make_batch` fed JAX's uniform label draw gives `sample(key)`
    bitwise; the port's own draw is a [B] int64 pick in range."""
    jg, pg = _graphs(graph_dirs, "classed", "numpy", request)
    kw = dict(max_nodes=MAX_NODES, max_degree=MAX_DEGREE)
    jflow = JaxDeviceWholeGraphFlow(jg, ["feat"], BATCH, **kw)
    pflow = DeviceWholeGraphFlow(pg, ["feat"], BATCH, **kw, device="cpu")
    assert (pflow.num_graphs, pflow.num_classes, pflow.grid) == (8, 2, jflow.grid)
    sample = jax.jit(jflow.sample)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        pick = np.asarray(jax.random.randint(key, (BATCH,), 0, jflow.num_graphs))
        _same_batch(sample(key), pflow.make_batch(torch.tensor(pick, dtype=torch.int64)))
    (pick,) = pflow.draw_inputs(torch.Generator().manual_seed(0))
    assert pick.dtype == torch.int64 and pick.shape == (BATCH,)
    assert 0 <= int(pick.min()) and int(pick.max()) < 8
    with pytest.raises(ValueError, match="no graph labels"):
        DeviceWholeGraphFlow(Graph.from_json({"nodes": [], "edges": []}), ["feat"], BATCH,
                             device="cpu")


@pytest.fixture(scope="module")
def pool_batch(graph_dirs):
    """A host GraphBatch of 4 graphs (one label out of range: an empty
    graph) and node rows of width 6."""
    pg = Graph.load(graph_dirs["classed"], native=False)
    b = WholeGraphDataFlow(pg, ["feat"], max_nodes=MAX_NODES,
                           max_degree=MAX_DEGREE).query(np.asarray([1, 2, 2, 11]))
    x = np.random.default_rng(1).normal(size=(b.feats.shape[0], 6)).astype(np.float32)
    return b, x


@pytest.mark.parametrize("pool", ["add", "mean", "max", "attention", "set2set"])
def test_pools_match_flax(pool, pool_batch):
    """Each readout's output and the grads of its params and input rows
    (a random cotangent) against the flax pool, fed its params."""
    b, x = pool_batch
    module = {"add": lambda: jax_pooling.Pooling(op="add"),
              "mean": lambda: jax_pooling.Pooling(op="mean"),
              "max": lambda: jax_pooling.Pooling(op="max"),
              "attention": lambda: jax_pooling.AttentionPool(dim=5),
              "set2set": jax_pooling.Set2SetPool}[pool]()
    ids, mask, g = jnp.asarray(b.graph_ids), jnp.asarray(b.node_mask), b.n_graphs
    rng = np.random.default_rng(3)
    params = {}
    if pool in ("attention", "set2set"):  # segment ops only: no params
        shapes = jax.eval_shape(
            lambda x: module.init(jax.random.PRNGKey(0), x, ids, g, mask=mask), x)
        params = jax.tree_util.tree_map(
            lambda s: rng.normal(0, 0.4, s.shape).astype(np.float32), shapes)["params"]
    port = POOLS[pool](6) if pool != "attention" else POOLS[pool](6, dim=5)
    width = {"set2set": 12, "attention": 5}.get(pool, 6)
    assert port.out_width == width
    cot = rng.normal(size=(g, width)).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, x, cot):
        out, vjp = jax.vjp(lambda p, x: module.apply({"params": p}, x, ids, g, mask=mask), p, x)
        return out, vjp(cot)

    want, (gp, gx) = fwd_bwd(params, jnp.asarray(x), jnp.asarray(cot))
    port.load_state_dict(from_flax({"params": params}))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, torch.from_numpy(b.graph_ids), g, mask=torch.from_numpy(b.node_mask))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    want_p = from_flax({"params": gp})
    assert sorted(want_p) == sorted(n for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_p[name].numpy(), err_msg=name, **TOL)


INIT_SEED = 5


def _assert_flax_init(got, want):
    """lecun_normal leaves within 2 ulp, the cells' orthogonal hidden
    kernels within 5e-6 (numpy factors in f64, XLA in f32)."""
    assert sorted(got) == sorted(want)
    for k in got:
        hidden = k.split(".")[-2] in ("hr", "hz", "hn", "hi", "hf", "hg", "ho")
        tol = dict(rtol=0, atol=5e-6) if hidden and k.endswith("weight") else \
            dict(rtol=2.5e-7, atol=0)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


@pytest.fixture(scope="module")
def flax_trees(graph_dirs):
    """The flax GraphClassifier of a (conv, pool) and the params the JAX
    Estimator draws for it at INIT_SEED (split(PRNGKey(seed), 1)[0]),
    memoized."""
    jg = JaxGraph.load(graph_dirs["classed"], native=False)
    batch = JaxWholeFlow(jg, ["feat"], max_nodes=MAX_NODES,
                         max_degree=MAX_DEGREE).query(np.arange(BATCH))
    memo = {}

    def get(conv, pool):
        if (conv, pool) not in memo:
            model = JaxGraphClassifier(conv=conv, dims=(8, 8), num_classes=2, pool=pool)
            key = jax.random.split(jax.random.PRNGKey(INIT_SEED), 1)[0]
            tree = jax.jit(lambda k, b: model.init({"params": k}, b))(key, batch)
            memo[conv, pool] = model, jax.tree_util.tree_map(np.asarray, tree)
        return memo[conv, pool]

    return get


CFG = dict(learning_rate=0.02, optimizer="adam", log_steps=10**9, seed=1)


def _port_classifier(graph_dirs, tree, pool, steps_per_call=1):
    """A port Estimator over GIN + `pool` from the flax params `tree`, over
    graph_label_batches of default_rng(2) (K-stacked when
    steps_per_call > 1)."""
    pg = Graph.load(graph_dirs["classed"], native=False)
    pf = WholeGraphDataFlow(pg, ["feat"], max_nodes=MAX_NODES, max_degree=MAX_DEGREE)
    pfn = graph_label_batches(pg, pf, BATCH, rng=np.random.default_rng(2))
    if steps_per_call > 1:
        pfn = stack_batches(pfn, steps_per_call)
    return Estimator(GraphClassifier(4, "gin", (8, 8), 2, pool), pfn,
                     EstimatorConfig(model_dir="unused", steps_per_call=steps_per_call, **CFG),
                     init_params=from_flax(tree), device="cpu")


@pytest.fixture(scope="module", params=["add", "set2set"])
def trained(request, graph_dirs, flax_trees):
    """3 adam steps of GIN + the pool in both packages from the JAX init."""
    pool = request.param
    model, tree = flax_trees("gin", pool)
    jg = JaxGraph.load(graph_dirs["classed"], native=False)
    jf = JaxWholeFlow(jg, ["feat"], max_nodes=MAX_NODES, max_degree=MAX_DEGREE)
    jest = JaxEstimator(model, jax_graph_label_batches(jg, jf, BATCH, rng=np.random.default_rng(2)),
                        JaxConfig(model_dir="unused", **CFG), init_params=tree)
    pest = _port_classifier(graph_dirs, tree, pool)
    jl = np.asarray(jest.train(3, log=False, save=False))
    pl = np.asarray(pest.train(3, log=False, save=False))
    return pool, tree, jest, pest, jl, pl


def test_graph_classifier_trains_as_jax(trained):
    """3 adam steps of GIN + `add` / `set2set`: the losses within 1e-5,
    the params within 1e-4 (adam's step divides by the root of the second
    moment, so an entry whose gradient is near 0 moves by a share of lr =
    0.02 that the f32 rounding of that gradient sets); `evaluate` reports
    accuracy under "acc"; `params.flax_init` draws the JAX Estimator's init
    (the LSTM's hidden kernels orthogonal)."""
    from euler_tpu_torch.params import flax_init

    pool, tree, jest, pest, jl, pl = trained
    assert len(pl) == 3 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, **TOL)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jest.params))
    got = pest.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, rtol=1e-5,
                                   atol=1e-4)
    evals = pest.evaluate([(pest.batch_fn()[0],)])
    assert set(evals) == {"loss", "acc"} and 0 <= evals["acc"] <= 1
    _assert_flax_init(flax_init(GraphClassifier(4, "gin", (8, 8), 2, pool), INIT_SEED),
                      from_flax(tree))


def test_graph_batches_stack_and_move(graph_dirs, flax_trees):
    """K = 2 calls over `stack_batches` of graph_label_batches train as K
    = 1 (n_graphs stays an int); a GraphBatch moves with dtypes kept; the
    device flow at K = 2 trains as at K = 1 (one generator a step), and
    with remat as without."""
    pool = "add"
    _, tree = flax_trees("gin", pool)
    pl = _port_classifier(graph_dirs, tree, pool).train(4, log=False, save=False)
    pest2 = _port_classifier(graph_dirs, tree, pool, steps_per_call=2)
    (stacked,) = pest2.batch_fn()
    assert stacked.n_graphs == BATCH and stacked.feats.shape[0] == 2
    pest2 = _port_classifier(graph_dirs, tree, pool, steps_per_call=2)
    np.testing.assert_allclose(pest2.train(4, log=False, save=False), pl, **TOL)
    (moved,) = args_to_device((stacked,), "cpu")
    assert isinstance(moved, GraphBatch) and moved.block.edge_src.dtype == torch.int32
    assert moved.hop_ids.dtype == torch.int32 and moved.n_graphs == BATCH
    pg = Graph.load(graph_dirs["classed"], native=False)
    losses = {}
    for k, remat in ((1, False), (2, False), (1, True)):
        flow = DeviceWholeGraphFlow(pg, ["feat"], BATCH, MAX_NODES, MAX_DEGREE, device="cpu")
        est = Estimator(GraphClassifier(4, "gin", (8, 8), 2, pool, remat=remat), flow,
                        EstimatorConfig(model_dir="unused", steps_per_call=k, seed=3,
                                        log_steps=10**9), device="cpu")
        losses[k, remat] = est.train(4, log=False, save=False)
        assert dataclasses.is_dataclass(est.batch(0)) and est.batch(0).n_graphs == BATCH
    assert losses[1, False] == losses[2, False] and np.isfinite(losses[1, False]).all()
    assert losses[1, True] == losses[1, False]  # remat recomputes the same numbers


@pytest.mark.parametrize("conv,pool", [("gcn", "attention"), ("gated", "mean")])
def test_flax_init_draws_the_jax_init(conv, pool, flax_trees):
    """`params.flax_init` of a GraphClassifier against the params the JAX
    Estimator draws for its flax twin: the convs' trees under `convs_<l>`
    (GatedGraph's GRU), the attention pool's Denses under `pooler`, the
    `head` (GIN with `add` and `set2set`: `test_graph_classifier_trains_as_jax`)."""
    from euler_tpu_torch.params import flax_init

    _, tree = flax_trees(conv, pool)
    _assert_flax_init(flax_init(GraphClassifier(4, conv, (8, 8), 2, pool), INIT_SEED),
                      from_flax(tree))


def test_quality_recipes_run(monkeypatch):
    """`examples/graph_clf_quality.py`'s recipes (the JAX quality tests'),
    cut to 3 steps on a 100-graph stand-in: each reports its accuracy over
    one batch of 16 test graphs and its band."""
    from euler_tpu_torch.examples import graph_clf_quality as q

    monkeypatch.setattr(q, "STEPS", 3)
    g = Graph.from_json(mutag_like_json(n_graphs=100))
    for name, (conv, pool, band) in q.RECIPES.items():
        r = q.graph_clf_quality(name, "cpu", g)
        assert (r["conv"], r["pool"], r["band"], r["steps"]) == (conv, pool, band, 3)
        assert r["test_graphs"] == 16 and 0 <= r["acc"] <= 1


def test_mutag_stand_in_matches_jax():
    assert mutag_like_json() == jax_mutag_like_json()
    assert mutag_like_json(n_graphs=12, seed=4) == jax_mutag_like_json(n_graphs=12, seed=4)
