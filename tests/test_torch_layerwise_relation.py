"""The port's layer-wise (FastGCN / AdaptiveGCN) and relation (RGCN)
families against the JAX package: `layerwise_from_full`,
`sample_neighbor_layerwise` and the host flows' batches bitwise from one
numpy seed (the numpy store on one and two shards, and the native
engine), `DeviceRelationFlow` / `DeviceLayerwiseFlow.make_batch` fed
JAX's uniform and Gumbel draws (ids and masks bitwise, adjacencies within
1e-6; unit weights, where the cumsums are exact), `RelationConv`
(num_bases 0 and 2), `RGCNSupervised` and `LayerwiseGCN` against flax
through `params.from_flax` (forward and grads within 1e-5), 3 adam steps
on host and device batches within 1e-5 of JAX's losses (steps_per_call 1
and 2), and `params.flax_init` of the new params within 2 ulp of flax's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
from euler_tpu.dataflow import DeviceLayerwiseFlow as JaxDeviceLayerwiseFlow
from euler_tpu.dataflow import DeviceRelationFlow as JaxDeviceRelationFlow
from euler_tpu.dataflow import LayerwiseDataFlow as JaxLayerwiseDataFlow
from euler_tpu.dataflow import RelationDataFlow as JaxRelationDataFlow
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.graph.store import layerwise_from_full as jax_layerwise_from_full
from euler_tpu.layers import RelationConv as JaxRelationConv
from euler_tpu.models import LayerwiseGCN as JaxLayerwiseGCN
from euler_tpu.models import RGCNSupervised as JaxRGCN
from euler_tpu_torch.dataflow import (
    DeviceLayerwiseFlow,
    DeviceRelationFlow,
    LayerwiseDataFlow,
    RelationDataFlow,
    to_device,
)
from euler_tpu_torch.estimator import Estimator, EstimatorConfig, stack_batches
from euler_tpu_torch.graph import Graph, convert_json, native
from euler_tpu_torch.graph.store import layerwise_from_full
from euler_tpu_torch.layers import RelationConv
from euler_tpu_torch.models import LayerwiseGCN, RGCNSupervised
from euler_tpu_torch.params import checkpoint_order, flax_init, from_flax, to_flax_leaf

torch.set_num_threads(1)

FEAT, LABELS, NTYPES, DIMS = 6, 3, 3, [8, 8]
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)
# 10**9 is not in the graph; 7 repeats
ROOTS = np.asarray([1, 7, 7, 40, 10**9, 23], np.uint64)


def typed_graph_json(n: int = 80, max_deg: int = 6, seed: int = 0) -> dict:
    """A unit-weight digraph of NTYPES edge types: out-degrees 0..max_deg
    (node 5 has none), FEAT-wide normal features, one-hot labels."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    for i in range(1, n + 1):
        nodes.append({"id": i, "type": i % 2, "weight": 1.0, "features": [
            {"name": "feature", "type": "dense",
             "value": rng.normal(size=FEAT).astype(np.float32).tolist()},
            {"name": "label", "type": "dense", "value": np.eye(LABELS)[i % LABELS].tolist()}]})
    for i in range(1, n + 1):
        for _ in range(0 if i == 5 else int(rng.integers(0, max_deg + 1))):
            edges.append({"src": i, "dst": int(rng.integers(1, n + 1)),
                          "type": int(rng.integers(0, NTYPES)), "weight": 1.0, "features": []})
    return {"nodes": nodes, "edges": edges}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The typed graph as a graph dir on one shard and on two."""
    j = typed_graph_json()
    out = {}
    for parts in (1, 2):
        d = str(tmp_path_factory.mktemp(f"typed{parts}"))
        convert_json(j, d, num_partitions=parts)
        out[parts] = d
    return out


@pytest.fixture(scope="module")
def engine():
    """The port's engine, built once; the JAX binding is pointed at it."""
    path = native.build_engine()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "build_engine", lambda force=False: path)
    mp.setattr(jax_native, "_lib", None)
    yield path
    mp.undo()


@pytest.fixture(scope="module")
def graphs(dirs):
    """(jax, port) graphs of the numpy store, one shard."""
    return JaxGraph.load(dirs[1], native=False), Graph.load(dirs[1], native=False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def _same_fields(jb, pb, close=()):
    """Two batches (LayerwiseBatch or RelMiniBatch) field by field; the
    fields in `close` within 1e-6."""
    for name in ("feats", "masks", "root_idx", "labels", "hop_ids", "adjs", "rel_blocks"):
        if not hasattr(jb, name):
            continue
        a, b = getattr(jb, name), getattr(pb, name)
        if name == "rel_blocks":
            for ha, hb in zip(a, b, strict=True):
                for x, y in zip(ha, hb, strict=True):
                    assert (x.n_src, x.n_dst) == (y.n_src, y.n_dst)
                    for f in ("edge_src", "edge_dst", "edge_w", "mask"):
                        _same(getattr(x, f), getattr(y, f))
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,),
                        strict=True):
            if name in close:
                np.testing.assert_allclose(_np(y), _np(x), rtol=1e-6, atol=1e-6)
            else:
                _same(x, y)


# ---- host sampling ---------------------------------------------------------


@pytest.mark.parametrize("count", [3, 40])
def test_layerwise_from_full_matches_jax(count):
    rng = np.random.default_rng(9)
    nbr = rng.integers(1, 30, (7, 5)).astype(np.uint64)
    w = rng.uniform(0.5, 2.0, (7, 5)).astype(np.float32)
    mask = rng.random((7, 5)) > 0.3
    mask[2] = False  # a row with no neighbour
    got = layerwise_from_full(nbr, w, mask, count, np.random.default_rng(1))
    want = jax_layerwise_from_full(nbr, w, mask, count, np.random.default_rng(1))
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    empty = np.zeros_like(mask)
    for a, b in zip(jax_layerwise_from_full(nbr, w, empty, count, None),
                    layerwise_from_full(nbr, w, empty, count, None), strict=True):
        _same(a, b)


def _host_checks(jg, pg):
    for count in (4, 200):
        got = pg.sample_neighbor_layerwise(ROOTS, None, count, np.random.default_rng(count))
        want = jg.sample_neighbor_layerwise(ROOTS, None, count, np.random.default_rng(count))
        for a, b in zip(want, got, strict=True):
            _same(a, b)
    got = pg.sample_neighbor_layerwise(ROOTS, [1], 5, np.random.default_rng(2))
    want = jg.sample_neighbor_layerwise(ROOTS, [1], 5, np.random.default_rng(2))
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    for jcls, pcls, kw in (
        (JaxLayerwiseDataFlow, LayerwiseDataFlow, dict(layer_sizes=[10, 6])),
        (JaxLayerwiseDataFlow, LayerwiseDataFlow, dict(layer_sizes=[10, 6], normalize=False)),
        (JaxRelationDataFlow, RelationDataFlow, dict(num_relations=NTYPES, fanout=2)),
    ):
        jf = jcls(jg, ["feature"], label_feature="label", rng=np.random.default_rng(5), **kw)
        pf = pcls(pg, ["feature"], label_feature="label", rng=np.random.default_rng(5), **kw)
        for _ in range(2):
            _same_fields(jf.query(ROOTS), pf.query(ROOTS))


@pytest.mark.parametrize("parts", [1, 2])
def test_host_sampling_matches_jax(dirs, parts):
    _host_checks(JaxGraph.load(dirs[parts], native=False), Graph.load(dirs[parts], native=False))


def test_native_host_sampling_matches_jax_binding(dirs, engine):
    """The engine's layer draw, bound by each package, from one seed (one
    process, so one core count)."""
    jg, pg = JaxGraph.load(dirs[1], native=True), Graph.load(dirs[1], native=True)
    assert type(pg.shards[0]).__name__ == "NativeGraphStore"
    _host_checks(jg, pg)


# ---- device flows fed JAX's draws -----------------------------------------


B, FANOUT, LAYERS = 4, 2, [6, 5]


@pytest.fixture(scope="module")
def device_flows(graphs):
    jg, pg = graphs
    rel = dict(num_relations=NTYPES, batch_size=B, fanout=FANOUT, num_hops=2,
               label_feature="label", root_node_type=1)
    lw = dict(batch_size=B, layer_sizes=LAYERS, label_feature="label")
    return {
        "relation": (JaxDeviceRelationFlow(jg, ["feature"], **rel),
                     DeviceRelationFlow(pg, ["feature"], **rel, device="cpu")),
        "layerwise": (JaxDeviceLayerwiseFlow(jg, ["feature"], **lw),
                      DeviceLayerwiseFlow(pg, ["feature"], **lw, device="cpu")),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def relation_draws(jf, key):
    """The numbers JAX's DeviceRelationFlow.sample(key) draws
    (device.py:1392-1404), as the port's draw_inputs returns them."""
    keys = jax.random.split(key, 1 + jf.num_hops * jf.num_relations)
    roots = _t(jf._draw_roots(keys[0], jf.batch_size))
    draws, width, ki = [], jf.batch_size, 1
    for _ in range(jf.num_hops):
        for _ in range(jf.num_relations):
            draws.append(_t(jax.random.uniform(keys[ki], (width, jf.fanout))))
            ki += 1
        width *= jf.num_relations * jf.fanout
    return roots, tuple(draws)


def layerwise_draws(jf, key):
    """The numbers JAX's DeviceLayerwiseFlow.sample(key) draws
    (device.py:1523-1528): the roots and each layer's Gumbel noise."""
    keys = jax.random.split(key, 1 + len(jf.layer_sizes))
    roots = _t(jf._draw_roots(keys[0], jf.batch_size))
    return roots, tuple(_t(jax.random.gumbel(k, (jf.num_nodes + 1,))) for k in keys[1:])


DRAWS = {"relation": relation_draws, "layerwise": layerwise_draws}


@pytest.mark.parametrize("kind", ["relation", "layerwise"])
def test_device_flow_matches_jax(device_flows, kind):
    jf, pf = device_flows[kind]
    assert pf.layout == jf.layout == "dense" and pf.unit_w
    if kind == "relation":
        _same(jf.ttab, pf.ttab)
    sample = jax.jit(jf.sample)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        _same_fields(sample(key), pf.make_batch(*DRAWS[kind](jf, key)), close=("adjs",))


def test_device_flows_refuse_paged(graphs):
    """The type plane is dense only, as in the JAX package: a graph past
    max_degree raises instead of staging paged."""
    from euler_tpu_torch.dataflow import DeviceGraphTables

    _, pg = graphs
    with pytest.raises(ValueError, match="exceeds max_degree"):
        DeviceRelationFlow(pg, ["feature"], NTYPES, B, max_degree=1, device="cpu")
    with pytest.raises(ValueError, match="paged layout"):
        DeviceGraphTables(pg, stage_types=True, layout="paged", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        DeviceLayerwiseFlow(pg, ["feature"], B, mesh=object(), device="cpu")


# ---- the models against flax ------------------------------------------------


def _random_params(module, seed, *args):
    """A flax param tree of `module` (traced, not run) with seeded normal
    leaves: N(0, 1/fan_in) kernels and relation weights, N(0, 0.1) biases
    and basis coefficients."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0
        std = fan_in**-0.5 if fan_in > 4 else 0.1
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


@pytest.fixture(scope="module")
def host_batches(graphs):
    """(jax, port) batches of both host flows, bitwise equal (above)."""
    jg, pg = graphs
    out = {}
    for kind, jcls, pcls, kw in (
        ("relation", JaxRelationDataFlow, RelationDataFlow,
         dict(num_relations=NTYPES, fanout=FANOUT)),
        ("layerwise", JaxLayerwiseDataFlow, LayerwiseDataFlow, dict(layer_sizes=LAYERS)),
    ):
        jf = jcls(jg, ["feature"], label_feature="label", rng=np.random.default_rng(4), **kw)
        pf = pcls(pg, ["feature"], label_feature="label", rng=np.random.default_rng(4), **kw)
        out[kind] = [(jf.query(ROOTS), pf.query(ROOTS)) for _ in range(4)]
    return out


def _grads_match(jfn, tree, pm, pfn):
    """jfn(tree) -> (scalar, aux) on the JAX side; pfn() the port's on pm
    loaded with tree: values and every param's grad within TOL."""
    (jval, jaux), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(tree)
    pm.load_state_dict(from_flax(tree))
    val, aux = pfn()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), **TOL)
    for a, b in zip(jaux, aux, strict=True):
        np.testing.assert_allclose(_np(b.detach()), np.asarray(a), **TOL)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("num_bases", [0, 2])
def test_relation_conv_matches_flax(host_batches, num_bases):
    jb, pb = host_batches["relation"][0]
    pb = to_device(pb, "cpu")
    jm = JaxRelationConv(out_dim=5, num_relations=NTYPES, num_bases=num_bases)
    jargs = (jb.feats[0], jb.feats[1], jb.rel_blocks[0])
    tree = _random_params(jm, num_bases, *jargs)
    assert set(tree["params"]) == {"Dense_0"} | ({"basis", "coef"} if num_bases else {"rel_w"})
    cot = np.random.default_rng(1).normal(size=(len(ROOTS), 5)).astype(np.float32)
    pm = RelationConv(FEAT, 5, num_relations=NTYPES, num_bases=num_bases)

    def jfn(p):
        out = jm.apply(p, *jargs)
        return jnp.sum(out * cot), (out,)

    def pfn():
        out = pm(pb.feats[0], pb.feats[1], pb.rel_blocks[0])
        return torch.sum(out * torch.from_numpy(cot)), (out,)

    _grads_match(jfn, tree, pm, pfn)


MODELS = {
    "relation": (lambda: JaxRGCN(dims=DIMS, num_relations=NTYPES, label_dim=LABELS, num_bases=2),
                 lambda: RGCNSupervised(FEAT, DIMS, NTYPES, LABELS, num_bases=2)),
    "layerwise": (lambda: JaxLayerwiseGCN(dims=DIMS, label_dim=LABELS),
                  lambda: LayerwiseGCN(FEAT, DIMS, LABELS)),
}


@pytest.mark.parametrize("kind", ["relation", "layerwise"])
def test_model_matches_flax(host_batches, kind):
    jb, pb = host_batches[kind][0]
    pb = to_device(pb, "cpu")
    jm, pm = MODELS[kind][0](), MODELS[kind][1]()
    tree = _random_params(jm, 7, jb)

    def jfn(p):
        emb, loss, _, metric = jm.apply(p, jb)
        return loss, (emb, metric)

    def pfn():
        emb, loss, name, metric = pm(pb)
        assert name == "f1"
        return loss, (emb, metric)

    _grads_match(jfn, tree, pm, pfn)


@pytest.mark.parametrize("kind", ["relation", "layerwise"])
def test_host_estimator_matches_jax(host_batches, kind, tmp_path):
    """3 adam steps from one flax tree on the same host batches: JAX's
    step, the port's at K = 1 and at K = 2 over `stack_batches`."""
    pairs = host_batches[kind]
    jm = MODELS[kind][0]()
    tree = _random_params(jm, 8, pairs[0][0])
    it = iter([(j,) for j, _ in pairs])
    jest = JaxEstimator(jm, lambda: next(it), JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    for k in (1, 2):
        it = iter([(p,) for _, p in pairs])
        fn = (lambda: next(it)) if k == 1 else stack_batches(lambda: next(it), 2)
        pest = Estimator(MODELS[kind][1](), fn,
                         EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                         **CFG),
                         init_params=from_flax(tree), device="cpu")
        pl = np.asarray(pest.train(3, log=False, save=False))
        np.testing.assert_allclose(pl, jl, **TOL)


@pytest.mark.parametrize("kind", ["relation", "layerwise"])
def test_device_flow_estimator_matches_jax(device_flows, host_batches, kind, tmp_path):
    """3 adam steps on the device flow: JAX's train step against the port
    fed JAX's per-step draws, at K = 1 and 2."""
    jf, pf = device_flows[kind]
    jm = MODELS[kind][0]()
    tree = _random_params(jm, 9, host_batches[kind][0][0])
    jest = JaxEstimator(jm, jf, JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    flow_key = jax.random.PRNGKey(CFG["seed"] + 2)
    draws = [DRAWS[kind](jf, jax.random.fold_in(flow_key, s)) for s in range(3)]
    for k in (1, 2):
        it = iter(draws)
        pf.draw_inputs = lambda gen: next(it)
        try:
            pest = Estimator(MODELS[kind][1](), pf,
                             EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                             **CFG),
                             init_params=from_flax(tree), device="cpu")
            pl = np.asarray(pest.train(3, log=False, save=False))
        finally:
            del pf.draw_inputs
        np.testing.assert_allclose(pl, jl, **TOL)


@pytest.mark.parametrize("kind", ["relation", "layerwise"])
def test_flax_init_matches_flax(host_batches, kind):
    """`params.flax_init` against the params the JAX Estimator draws at
    seeds 0 and 5 (split(PRNGKey(seed), 1)[0]): the new params (basis,
    coef, rel_w) within 2 ulp; the Dense leaves within the bound
    tests/test_torch_convs.py holds them to (rtol 2.5e-7: numpy's log1p
    inside XLA's erf_inv rounds to the other neighbour now and then, and
    at seed 5 a kernel value lands 3 ulp off flax's)."""
    jb = host_batches[kind][0][0]
    jm = MODELS[kind][0]()
    init = jax.jit(jm.init)
    for seed in (0, 5):
        want = init({"params": jax.random.split(jax.random.PRNGKey(seed), 1)[0]}, jb)
        got = flax_init(MODELS[kind][1](), seed)
        wl = jax.tree_util.tree_leaves(want)
        keys = checkpoint_order(got)
        assert len(wl) == len(keys)
        for a, k in zip(wl, keys):
            b, a = to_flax_leaf(k, got[k]), np.asarray(a)
            assert a.shape == b.shape, k
            if k.rsplit(".", 1)[-1] in ("basis", "coef", "rel_w"):
                np.testing.assert_array_max_ulp(b, a, maxulp=2)
            else:
                np.testing.assert_allclose(b, a, rtol=2.5e-7, atol=0, err_msg=k)
