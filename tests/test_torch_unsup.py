"""The port's unsupervised GraphSAGE family against the JAX package:
`unsupervised_batches` and `edge_batches` bitwise from one seed,
`DeviceUnsupSageFlow` fed JAX's draws bitwise (dense and paged layouts,
weighted and unit edges, the global negative CDF), `SuperviseModel`,
`UnsuperviseModel` and `GraphSAGEUnsupervised` (loss, metric and grads
within 1e-5 on `from_flax` params; JAX's SAGEConv on its plain segment-op
path; and with the ShallowEncoder stage over the batches' hop ids), a
few Estimator steps on the device flow (steps_per_call 1 and 2) and on
the host source within 1e-4 of JAX's losses, and the options not ported
yet, which raise naming their ROADMAP item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import DeviceUnsupSageFlow as JaxDeviceUnsupSageFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.dataflow.base import hydrate_blocks as jax_hydrate_blocks
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.estimator import edge_batches as jax_edge_batches
from euler_tpu.estimator import unsupervised_batches as jax_unsupervised_batches
from euler_tpu.models import GraphSAGEUnsupervised as JaxUnsup
from euler_tpu.nn import SuperviseModel as JaxSuperviseModel
from euler_tpu.nn import UnsuperviseModel as JaxUnsuperviseModel
from euler_tpu_torch.dataflow import DeviceUnsupSageFlow, SageDataFlow, hydrate_blocks
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
from euler_tpu_torch.estimator import edge_batches, unsupervised_batches
from euler_tpu_torch.models import GraphSAGEUnsupervised
from euler_tpu_torch.nn import SuperviseModel, UnsuperviseModel
from euler_tpu_torch.params import checkpoint_order, from_flax, to_flax_leaf

torch.set_num_threads(1)

FEAT, DIMS, FANOUTS, BATCH, NEGS = 6, [8, 8], [3, 2], 6, 2
CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)


@pytest.fixture(scope="module")
def graphs():
    """(jax, port) random graphs, weighted and unit-weight."""
    out = {}
    for weighted in (True, False):
        kw = dict(num_nodes=200, out_degree=5, feat_dim=FEAT, seed=6, weighted=weighted)
        out[weighted] = (jax_random_graph(**kw), random_graph(**kw))
    return out


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _same_batch(jb, pb):
    """Two MiniBatches leaf for leaf (None where either leaves one out)."""
    pairs = list(zip(jb.feats, pb.feats)) + [(jb.root_idx, pb.root_idx),
                                             (jb.labels, pb.labels)]
    assert (jb.masks is None) == (pb.masks is None)
    if jb.masks is not None:
        pairs += list(zip(jb.masks, pb.masks))
    for a, b in zip(jb.blocks, pb.blocks):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        pairs += [(a.edge_src, b.edge_src), (a.edge_dst, b.edge_dst), (a.edge_w, b.edge_w),
                  (a.mask, b.mask)]
    assert (jb.hop_ids is None) == (pb.hop_ids is None)
    pairs += list(zip(jb.hop_ids or (), pb.hop_ids or (), strict=True))
    for a, b in pairs:
        assert (a is None) == (b is None)
        if a is not None:
            _same(_np(a), _np(b))


# ---- host sources --------------------------------------------------------


def test_host_sources_match_jax(graphs):
    jg, pg = graphs[True]
    jflow = JaxSageDataFlow(jg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(1))
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(1))
    js = jax_unsupervised_batches(jg, jflow, BATCH, num_negs=NEGS, rng=np.random.default_rng(2))
    ps = unsupervised_batches(pg, pflow, BATCH, num_negs=NEGS, rng=np.random.default_rng(2))
    je = jax_edge_batches(jg, jflow, BATCH, rng=np.random.default_rng(3))
    pe = edge_batches(pg, pflow, BATCH, rng=np.random.default_rng(3))
    for src_j, src_p in ((js, ps), (je, pe)):
        for _ in range(2):
            jt, pt = src_j(), src_p()
            assert len(jt) == len(pt)
            for a, b in zip(jt, pt):
                _same_batch(a, b)


# ---- the device flow fed JAX's draws -------------------------------------


def _hops(jf, key, width):
    draws = []
    for k, hk in zip(jf.fanouts, jax.random.split(key, len(jf.fanouts))):
        draws.append(_draw(jf, hk, width, k))
        width *= k
    return tuple(draws)


def _draw(jf, key, width, k):
    if jf.unit_w:
        return torch.from_numpy(np.array(jax.random.uniform(key, (width, k))))
    return torch.from_numpy(
        np.array(jax.random.bits(key, (width, k), dtype=jnp.uint32)).view(np.int32))


def unsup_draws(jf, key):
    """The random numbers JAX's DeviceUnsupSageFlow.sample(key) draws
    (device.py:1113-1121), as the port's draw_inputs returns them."""
    kroot, kpos, kneg, ks, kp, kn = jax.random.split(key, 6)
    b = jf.batch_size
    src = torch.from_numpy(np.array(jf._draw_roots(kroot, b)))
    negs = torch.from_numpy(np.array(jf._draw_global_nodes(kneg, b * jf.num_negs)))
    return (src, _draw(jf, kpos, b, 1), negs, _hops(jf, ks, b), _hops(jf, kp, b),
            _hops(jf, kn, b * jf.num_negs))


def _flows(graphs, weighted, layout, **kw):
    jg, pg = graphs[weighted]
    fkw = dict(fanouts=FANOUTS, batch_size=BATCH, num_negs=NEGS, layout=layout, page_size=8,
               **kw)
    return JaxDeviceUnsupSageFlow(jg, **fkw), DeviceUnsupSageFlow(pg, **fkw, device="cpu")


@pytest.fixture(scope="module")
def flows(graphs):
    """(jax flow, port flow, jitted JAX sample) by (weighted, layout),
    staged once for the module under the f32 weight plane, with hop ids
    (each of the three batches carries its own)."""
    made = {}

    def get(weighted, layout):
        if (weighted, layout) not in made:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("EULER_TPU_PAGE_DTYPE", "f32")
                jf, pf = _flows(graphs, weighted, layout, root_node_type=0, with_hop_ids=True)
            made[weighted, layout] = (jf, pf, jax.jit(jf.sample))
        return made[weighted, layout]

    return get


@pytest.mark.parametrize("layout,weighted", [("dense", True), ("paged", True),
                                             ("paged", False)])
def test_unsup_flow_matches_jax(flows, layout, weighted):
    jf, pf, sample = flows(weighted, layout)
    assert jf.layout == pf.layout == layout
    for name in ("node_cdf", "global_cdf", "roots"):
        a, b = getattr(jf, name), getattr(pf, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _same(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.uint32
                  else np.asarray(a), b)
    for s in range(2):
        key = jax.random.PRNGKey(s)
        want, got = sample(key), pf.make_batch(*unsup_draws(jf, key))
        assert len(want) == len(got) == 3
        for a, b in zip(want, got):
            _same_batch(a, b)


def test_unported_options_raise(graphs):
    jg, pg = graphs[False]
    # with_hop_ids and the encoder stage are ported: the flags reach the
    # flow, whose three batches each carry their ids, and the model
    flow = DeviceUnsupSageFlow(pg, FANOUTS, BATCH, with_hop_ids=True, device="cpu")
    assert flow.with_hop_ids
    assert all(len(b.hop_ids) == len(FANOUTS) + 1
               for b in flow.sample(torch.Generator().manual_seed(0)))
    model = GraphSAGEUnsupervised(FEAT, DIMS, encoder_dim=8, max_id=10)
    assert model.net.encoder.max_id == 10 and model.net.encoder.dim == 8
    assert model.net.gnn.convs[0].in_dim == 8
    with pytest.raises(NotImplementedError, match="item 6"):
        DeviceUnsupSageFlow(pg, FANOUTS, BATCH, mesh=object(), device="cpu")
    with pytest.raises(KeyError, match="unknown conv"):
        SuperviseModel(FEAT, "relation", DIMS, 2)
    # remat is ported: the flag reaches the conv stack
    assert UnsuperviseModel(FEAT, "sage", DIMS, remat=True).gnn.remat
    assert GraphSAGEUnsupervised(FEAT, DIMS, remat=True).net.gnn.remat


# ---- the models ----------------------------------------------------------


@pytest.fixture(scope="module")
def hydrated(graphs, flows):
    """One step's (src, pos, negs), hydrated by each package's cache."""
    jf, pf, sample = flows(True, "paged")
    jg, pg = graphs[True]
    jc, pc = JaxFeatureCache(jg, ["feat"]), DeviceFeatureCache(pg, ["feat"], device="cpu")
    key = jax.random.PRNGKey(7)
    # one program (op by op, each gather and mask would compile alone)
    jb = jax.jit(lambda bs: tuple(jc.hydrate(jax_hydrate_blocks(b)) for b in bs))(sample(key))
    pb = tuple(pc.hydrate(hydrate_blocks(b)) for b in pf.make_batch(*unsup_draws(jf, key)))
    return jb, pb, jf, pf, jc, pc


def _gnn_tree(prefix, seed, extra=None):
    """A flax param tree of the GNN (and the supervised head), kernels at
    a quarter of lecun scale: the features are O(5), so the logits and
    grads stay O(1) and the 1e-5 bound measures rounding, not scale."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.normal(0, 0.25 * i**-0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    gnn = {"gnn": {"convs_0": {"Dense_0": dense(2 * FEAT, DIMS[0])},
                   "convs_1": {"Dense_0": dense(2 * DIMS[0], DIMS[1])}}}
    tree = {prefix: gnn} if prefix else dict(gnn)
    if extra:
        tree["out"] = dense(DIMS[1], extra)
    return {"params": tree}


def _check_grads(jm, pm, tree, jargs, pargs):
    def loss_fn(p):
        _, loss, _, metric = jm.apply(p, *jargs)
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm.load_state_dict(from_flax(tree))
    _, loss, _, metric = pm(*pargs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metric.item(), float(jmetric), rtol=1e-5, atol=1e-5)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_graphsage_unsupervised_matches_jax(hydrated):
    jb, pb, *_ = hydrated
    _check_grads(JaxUnsup(dims=DIMS), GraphSAGEUnsupervised(FEAT, DIMS), _gnn_tree("net", 1),
                 jb, pb)


def test_graphsage_unsupervised_encoder_matches_jax(hydrated, tmp_path):
    """The encoder stage (ShallowEncoder(8, max_id=300) on every hop of
    src, pos and negs, over their own hop ids): loss, metric and grads
    within 1e-5, the id table's among them; 4 Estimator steps at
    steps_per_call 2 give finite losses."""
    jb, pb, *_ = hydrated
    rng = np.random.default_rng(7)
    tree = _gnn_tree("net", 8)
    tree["params"]["net"]["gnn"]["convs_0"]["Dense_0"]["kernel"] = rng.normal(
        0, 0.25 * 16**-0.5, (16, DIMS[0])).astype(np.float32)
    tree["params"]["net"]["encoder"] = {
        "Embedding_0": {"table": rng.normal(0, 0.1, (384, 8)).astype(np.float32)},
        "Dense_0": {"kernel": rng.normal(0, 0.25 * FEAT**-0.5, (FEAT, 8)).astype(np.float32),
                    "bias": rng.normal(0, 0.1, 8).astype(np.float32)}}
    _check_grads(JaxUnsup(dims=DIMS, encoder_dim=8, max_id=300),
                 GraphSAGEUnsupervised(FEAT, DIMS, encoder_dim=8, max_id=300), tree, jb, pb)
    # the Estimator trains it on the flow's hop ids at steps_per_call 2, as JAX's test does
    _, _, _, pf, _, pc = hydrated
    est = Estimator(GraphSAGEUnsupervised(FEAT, DIMS, encoder_dim=8, max_id=300), pf,
                    EstimatorConfig(model_dir=str(tmp_path), steps_per_call=2, **CFG),
                    feature_cache=pc, device="cpu")
    assert np.isfinite(est.train(4, log=False, save=False)).all()


def test_heads_match_jax(hydrated):
    jb, pb, *_ = hydrated
    _check_grads(JaxUnsuperviseModel(conv="sage", dims=DIMS, temperature=0.5),
                 UnsuperviseModel(FEAT, "sage", DIMS, temperature=0.5), _gnn_tree(None, 2),
                 jb, pb)
    labels = np.random.default_rng(3).random((BATCH, 3)) > 0.5
    jsrc = jb[0].replace(labels=jnp.asarray(labels, jnp.float32))
    psrc = type(pb[0])(**{**pb[0].__dict__, "labels": torch.from_numpy(labels).float()})
    _check_grads(JaxSuperviseModel(conv="sage", dims=DIMS, label_dim=3),
                 SuperviseModel(FEAT, "sage", DIMS, 3), _gnn_tree(None, 4, extra=3),
                 (jsrc,), (psrc,))


# ---- Estimator steps -----------------------------------------------------


def test_device_flow_estimator_matches_jax(hydrated, tmp_path):
    """3 adam steps on DeviceUnsupSageFlow: JAX's train step, the port fed
    JAX's per-step draws at K = 1 and 2 (on the CPU a call's steps run
    eagerly, so K = 2 is the same 3 steps)."""
    _, _, jf, pf, jc, pc = hydrated
    tree = _gnn_tree("net", 5)
    jest = JaxEstimator(JaxUnsup(dims=DIMS), jf, JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        feature_cache=jc, init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    flow_key = jax.random.PRNGKey(CFG["seed"] + 2)
    draws = [unsup_draws(jf, jax.random.fold_in(flow_key, s)) for s in range(3)]
    for k in (1, 2):
        it = iter(draws)
        pf.draw_inputs = lambda gen: next(it)
        pest = Estimator(GraphSAGEUnsupervised(FEAT, DIMS), pf,
                         EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                         **CFG),
                         feature_cache=pc, init_params=from_flax(tree), device="cpu")
        pl = np.asarray(pest.train(3, log=False, save=False))
        del pf.draw_inputs
        assert np.isfinite(pl).all()
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)


def test_host_source_estimator_matches_jax(graphs, tmp_path):
    """3 adam steps on the same unsupervised_batches from one flax init
    (drawn by each package's source from one seed), at steps_per_call 1
    (JAX's step) and the port's K = 2 over `stack_batches`."""
    from euler_tpu_torch.estimator import stack_batches

    jg, pg = graphs[False]
    flow = JaxSageDataFlow(jg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(4))
    src = jax_unsupervised_batches(jg, flow, BATCH, num_negs=NEGS, rng=np.random.default_rng(5))
    batches = [src() for _ in range(5)]
    tree = _gnn_tree("net", 6)
    it = iter(batches)
    jest = JaxEstimator(JaxUnsup(dims=DIMS), lambda: next(it),
                        JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(4))
    psrc = unsupervised_batches(pg, pflow, BATCH, num_negs=NEGS, rng=np.random.default_rng(5))
    pbatches = [psrc() for _ in range(5)]
    for k in (1, 2):
        it = iter(pbatches)
        fn = (lambda: next(it)) if k == 1 else stack_batches(lambda: next(it), 2)
        pest = Estimator(GraphSAGEUnsupervised(FEAT, DIMS), fn,
                         EstimatorConfig(model_dir=str(tmp_path / f"p{k}"), steps_per_call=k,
                                         **CFG),
                         init_params=from_flax(tree), device="cpu")
        pl = np.asarray(pest.train(3, log=False, save=False))
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
