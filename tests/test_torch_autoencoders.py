"""The port's GAE / VGAE / DGI family against the JAX package:
`gae_batches` / `dgi_batches` bitwise from one numpy seed,
`DeviceGaeFlow` / `DeviceDgiFlow.make_batch` fed JAX's bits and
permutations bitwise on the dense and the paged layouts (DGI's with hop
ids: the id plane rides the rows' permutation; each drawn dst a true
neighbour of its src), the models' loss, AUC and grads within
1e-5 of flax's on `from_flax` params (VGAE fed the normals JAX's
"reparam" stream draws), 3 adam steps on the device flows within 1e-5 of
JAX's losses (steps_per_call 1 and 2; VGAE's noise fed from JAX's
stream), the Estimator's model random stream, and `params.flax_init`
within 2 ulp of flax's.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import DeviceDgiFlow as JaxDeviceDgiFlow
from euler_tpu.dataflow import DeviceGaeFlow as JaxDeviceGaeFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.dataflow.base import hydrate_blocks as jax_hydrate_blocks
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.models import DGI as JaxDGI
from euler_tpu.models import GAE as JaxGAE
from euler_tpu.models import dgi_batches as jax_dgi_batches
from euler_tpu.models import gae_batches as jax_gae_batches
from euler_tpu_torch.dataflow import DeviceDgiFlow, DeviceGaeFlow, SageDataFlow, hydrate_blocks
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
from euler_tpu_torch.estimator.estimator import rng_generator
from euler_tpu_torch.models import DGI, GAE, dgi_batches, gae_batches
from euler_tpu_torch.params import _fold_in_path, checkpoint_order, flax_init, from_flax
from euler_tpu_torch.params import to_flax_leaf

torch.set_num_threads(1)

FEAT, DIMS, FANOUTS, BATCH = 6, [8], [3], 6
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)


@pytest.fixture(scope="module")
def graphs():
    """(jax, port) random graphs, weighted and unit-weight."""
    out = {}
    for weighted in (True, False):
        kw = dict(num_nodes=150, out_degree=5, feat_dim=FEAT, seed=8, weighted=weighted)
        out[weighted] = (jax_random_graph(**kw), random_graph(**kw))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(b, a)


def _same_batch(jb, pb):
    """Two MiniBatches leaf for leaf (None where either leaves one out)."""
    pairs = list(zip(jb.feats, pb.feats, strict=True)) + [(jb.root_idx, pb.root_idx),
                                                          (jb.labels, pb.labels)]
    assert (jb.masks is None) == (pb.masks is None)
    if jb.masks is not None:
        pairs += list(zip(jb.masks, pb.masks, strict=True))
    for a, b in zip(jb.blocks, pb.blocks, strict=True):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        pairs += [(a.edge_src, b.edge_src), (a.edge_dst, b.edge_dst), (a.edge_w, b.edge_w),
                  (a.mask, b.mask)]
    assert (jb.hop_ids is None) == (pb.hop_ids is None)
    pairs += list(zip(jb.hop_ids or (), pb.hop_ids or (), strict=True))
    for a, b in pairs:
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)


# ---- host sources ------------------------------------------------------------


def test_host_sources_match_jax(graphs):
    jg, pg = graphs[True]
    jflow = JaxSageDataFlow(jg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(1))
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(1))
    for jsrc, psrc in (
        (jax_gae_batches(jg, jflow, BATCH, rng=np.random.default_rng(2)),
         gae_batches(pg, pflow, BATCH, rng=np.random.default_rng(2))),
        (jax_dgi_batches(jg, jflow, BATCH, rng=np.random.default_rng(3)),
         dgi_batches(pg, pflow, BATCH, rng=np.random.default_rng(3))),
    ):
        for _ in range(2):
            jt, pt = jsrc(), psrc()
            assert len(jt) == len(pt)
            for a, b in zip(jt, pt):
                _same_batch(a, b)


# ---- the device flows fed JAX's draws --------------------------------------


def _draw(jf, key, width, k):
    if jf.unit_w:
        return torch.from_numpy(np.array(jax.random.uniform(key, (width, k))))
    return torch.from_numpy(
        np.array(jax.random.bits(key, (width, k), dtype=jnp.uint32)).view(np.int32))


def _hops(jf, key, width):
    draws = []
    for k, hk in zip(jf.fanouts, jax.random.split(key, len(jf.fanouts))):
        draws.append(_draw(jf, hk, width, k))
        width *= k
    return tuple(draws)


def _t(x):
    return torch.from_numpy(np.array(x))


def gae_draws(jf, key):
    """The numbers JAX's DeviceGaeFlow.sample(key) draws
    (device.py:1571-1580), as the port's draw_inputs returns them."""
    ksrc, kdst, kneg, k1, k2, k3 = jax.random.split(key, 6)
    b = jf.batch_size
    return (_t(jf._draw_edge_sources(ksrc, b)), _draw(jf, kdst, b, 1),
            _t(jf._draw_global_nodes(kneg, b)), _hops(jf, k1, b), _hops(jf, k2, b),
            _hops(jf, k3, b))


def dgi_draws(jf, key):
    """The numbers JAX's DeviceDgiFlow.sample(key) draws
    (device.py:1591-1609): the roots, the hops' draws, one permutation a
    hop."""
    kmb, kperm = jax.random.split(key)
    kroot, khops = jax.random.split(kmb)
    b = jf.batch_size
    widths = [b]
    for k in jf.fanouts:
        widths.append(widths[-1] * k)
    perms = tuple(_t(jax.random.permutation(pk, w))
                  for pk, w in zip(jax.random.split(kperm, len(widths)), widths))
    return _t(jf._draw_roots(kroot, b)), _hops(jf, khops, b), perms


FLOWS = {"gae": (JaxDeviceGaeFlow, DeviceGaeFlow, gae_draws),
         "dgi": (JaxDeviceDgiFlow, DeviceDgiFlow, dgi_draws)}


@pytest.fixture(scope="module")
def flows(graphs):
    """(jax flow, port flow, jitted JAX sample) by (kind, weighted,
    layout), staged under the f32 weight plane; the DGI flows carry hop
    ids."""
    made = {}

    def get(kind, weighted, layout):
        if (kind, weighted, layout) not in made:
            jg, pg = graphs[weighted]
            jcls, pcls, _ = FLOWS[kind]
            kw = dict(fanouts=FANOUTS, batch_size=BATCH, layout=layout, page_size=8)
            if kind == "dgi":  # the id plane rides the rows' permutation
                kw["with_hop_ids"] = True
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("EULER_TPU_PAGE_DTYPE", "f32")
                jf, pf = jcls(jg, **kw), pcls(pg, **kw, device="cpu")
            made[kind, weighted, layout] = (jf, pf, jax.jit(jf.sample))
        return made[kind, weighted, layout]

    return get


@pytest.mark.parametrize("kind", ["gae", "dgi"])
@pytest.mark.parametrize("layout,weighted", [("dense", True), ("paged", True),
                                             ("paged", False)])
def test_device_flow_matches_jax(flows, graphs, kind, layout, weighted):
    jf, pf, sample = flows(kind, weighted, layout)
    assert jf.layout == pf.layout == layout
    if kind == "gae":
        _same(np.asarray(jf.edge_src_cdf).astype(np.int64), pf.edge_src_cdf)
    pg = graphs[weighted][1]
    for s in range(2):
        key = jax.random.PRNGKey(s)
        want, got = sample(key), pf.make_batch(*FLOWS[kind][2](jf, key))
        assert len(want) == len(got) == (3 if kind == "gae" else 2)
        for a, b in zip(want, got):
            _same_batch(a, b)
        if kind == "gae":
            # every drawn dst is a neighbour of its src
            src, dst = (pf.node_id[b.feats[0]].numpy().astype(np.uint64) for b in got[:2])
            nbr, _, _, mask, _ = pg.get_full_neighbor(src)
            assert all(d in set(row[m]) for d, row, m in zip(dst, nbr, mask))
        else:
            assert not torch.equal(got[0].feats[1], got[1].feats[1])


# ---- the models against flax --------------------------------------------------


def _random_params(module, seed, *args, rngs=None):
    shapes = jax.eval_shape(lambda k, *a: module.init({"params": k, **(rngs or {})}, *a),
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0
        # a quarter of lecun's scale: the features are O(5), so the logits
        # stay O(1) and the bound measures rounding, not scale
        std = 0.25 * fan_in**-0.5 if fan_in > 4 else 0.1
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


@pytest.fixture(scope="module")
def hydrated(flows, graphs):
    """One step's batches of each flow, hydrated by each package's cache:
    {kind: (jax args, port args)}."""
    jg, pg = graphs[True]
    jc, pc = JaxFeatureCache(jg, ["feat"]), DeviceFeatureCache(pg, ["feat"], device="cpu")
    out = {}
    for kind in ("gae", "dgi"):
        jf, pf, sample = flows(kind, True, "paged")
        key = jax.random.PRNGKey(7)
        jb = jax.jit(lambda bs: tuple(jc.hydrate(jax_hydrate_blocks(b)) for b in bs))(sample(key))
        pb = tuple(pc.hydrate(hydrate_blocks(b)) for b in pf.make_batch(*FLOWS[kind][2](jf, key)))
        out[kind] = (jb, pb)
    return out


@contextlib.contextmanager
def recorded_normals():
    """Record what jax.random.normal returns while a flax apply runs
    (VGAE's three reparameterisation draws); inside a jitted function the
    records are its trace's values, which it returns (`vgae_normals`)."""
    seen = []
    normal = jax.random.normal

    def spy(*a, **kw):
        out = normal(*a, **kw)
        seen.append(out)
        return out

    jax.random.normal = spy
    try:
        yield seen
    finally:
        jax.random.normal = normal


def vgae_normals(jm, tree, jargs, rngs) -> list:
    """The normals VGAE's apply draws under `rngs`, from one jitted apply
    (an eager apply runs op by op, each op compiled on its own)."""
    def fn(tree, jargs, rngs):
        with recorded_normals() as seen:
            jm.apply(tree, *jargs, rngs=rngs)
        return tuple(seen)

    return [np.asarray(x) for x in jax.jit(fn)(tree, jargs, rngs)]


def _check(jm, pm, tree, jargs, pargs, jrngs=None, prngs=None):
    def loss_fn(p):
        _, loss, _, metric = jm.apply(p, *jargs, rngs=jrngs)
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm.load_state_dict(from_flax(tree))
    _, loss, name, metric = pm(*pargs, **({} if prngs is None else {"rngs": prngs}))
    assert name == "auc"
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(metric.item(), float(jmetric), **TOL)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_gae_matches_flax(hydrated):
    jb, pb = hydrated["gae"]
    jm = JaxGAE(dims=DIMS)
    tree = _random_params(jm, 1, *jb, rngs={"reparam": jax.random.PRNGKey(1)})
    assert set(tree["params"]) == {"encoder"}
    _check(jm, GAE(FEAT, DIMS), tree, jb, pb, {"reparam": jax.random.PRNGKey(1)})


def test_vgae_matches_flax_on_jax_noise(hydrated):
    """VGAE with the three normals JAX's "reparam" stream draws fed to the
    port as its `rngs` input."""
    jb, pb = hydrated["gae"]
    jm = JaxVGAE()
    rngs = {"reparam": jax.random.PRNGKey(4)}
    tree = _random_params(jm, 2, *jb, rngs=rngs)
    assert set(tree["params"]) == {"encoder", "mu_head", "logvar_head"}
    seen = vgae_normals(jm, tree, jb, rngs)
    assert len(seen) == 3 and seen[0].shape == (BATCH, DIMS[-1])
    eps = torch.from_numpy(np.stack(seen))
    _check(jm, GAE(FEAT, DIMS, variational=True), tree, jb, pb, rngs, {"reparam": eps})
    with pytest.raises(ValueError, match="rngs"):
        GAE(FEAT, DIMS, variational=True)(*pb)


def JaxVGAE():
    return JaxGAE(dims=DIMS, variational=True)


def test_dgi_matches_flax(hydrated):
    jb, pb = hydrated["dgi"]
    jm = JaxDGI(dims=DIMS)
    tree = _random_params(jm, 3, *jb)
    assert set(tree["params"]) == {"encoder", "bilinear"}
    _check(jm, DGI(FEAT, DIMS), tree, jb, pb)


def test_remat_refused(hydrated):
    """remat is no longer refused: GAE and DGI with remat=True give the
    loss and grads they give without it."""
    for cls, args in ((GAE, hydrated["gae"][1]), (DGI, hydrated["dgi"][1])):
        plain, remat = cls(FEAT, DIMS), cls(FEAT, DIMS, remat=True)
        remat.load_state_dict(plain.state_dict())
        assert remat.encoder.remat
        losses = []
        for m in (plain, remat):
            loss = m(*args)[1]
            loss.backward()
            losses.append(loss.item())
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6, atol=1e-7)
        for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)


# ---- Estimator steps ---------------------------------------------------------


def jax_reparam_noise(jest, step: int, rows: int) -> torch.Tensor:
    """The normals JAX's VGAE draws at train step `step`: the step's
    "reparam" key (`_rngs(step)`), folded as flax's make_rng folds a top
    module's first draw, split in three, one normal [rows, dim] each."""
    key = jest._rngs(step)["reparam"]
    data = np.asarray(jax.random.key_data(key) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key)
    folded = jnp.asarray(np.asarray(_fold_in_path(data, (1,)), np.uint32))
    keys = jax.random.split(folded, 3)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (rows, DIMS[-1])))
                                      for k in keys]))


MODELS = {"gae": (lambda: JaxGAE(dims=DIMS), lambda: GAE(FEAT, DIMS)),
          "vgae": (JaxVGAE, lambda: GAE(FEAT, DIMS, variational=True)),
          "dgi": (lambda: JaxDGI(dims=DIMS), lambda: DGI(FEAT, DIMS))}


def test_reparam_noise_is_jax_stream(hydrated):
    """`jax_reparam_noise` is what VGAE's apply draws from a step's key."""
    jb, _ = hydrated["gae"]
    jm = JaxVGAE()
    tree = _random_params(jm, 5, *jb, rngs={"reparam": jax.random.PRNGKey(0)})

    class Steps:  # the one method jax_reparam_noise reads
        @staticmethod
        def _rngs(step):
            return {"reparam": jax.random.fold_in(jax.random.PRNGKey(9), step)}

    seen = vgae_normals(jm, tree, jb, Steps._rngs(2))
    np.testing.assert_array_equal(jax_reparam_noise(Steps, 2, BATCH).numpy(), np.stack(seen))


@pytest.mark.parametrize("name", ["gae", "vgae", "dgi"])
def test_device_flow_estimator_matches_jax(flows, graphs, hydrated, name, tmp_path):
    """3 adam steps on the paged device flow: JAX's train step against the
    port fed JAX's per-step draws (and for VGAE JAX's per-step noise) at
    K = 1 and 2."""
    kind = "dgi" if name == "dgi" else "gae"
    jf, pf, _ = flows(kind, True, "paged")
    jg, pg = graphs[True]
    jm = MODELS[name][0]()
    rngs = {"reparam": jax.random.PRNGKey(0)} if kind == "gae" else None
    tree = _random_params(jm, 6, *hydrated[kind][0], rngs=rngs)
    jest = JaxEstimator(jm, jf, JaxConfig(model_dir=str(tmp_path / "j"), **CFG),
                        feature_cache=JaxFeatureCache(jg, ["feat"]),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(3, log=False, save=False))
    flow_key = jax.random.PRNGKey(CFG["seed"] + 2)
    draws = [FLOWS[kind][2](jf, jax.random.fold_in(flow_key, s)) for s in range(3)]
    noise = [jax_reparam_noise(jest, s, BATCH) for s in range(3)] if name == "vgae" else []
    for k in (1, 2):
        it, nit = iter(draws), iter(noise)
        pm = MODELS[name][1]()
        if name == "vgae":
            pm.draw_rngs = lambda gen, rows, device: {"reparam": next(nit)}
        pf.draw_inputs = lambda gen: next(it)
        try:
            pest = Estimator(pm, pf, EstimatorConfig(model_dir=str(tmp_path / f"p{k}"),
                                                     steps_per_call=k, **CFG),
                             feature_cache=DeviceFeatureCache(pg, ["feat"], device="cpu"),
                             init_params=from_flax(tree), device="cpu")
            pl = np.asarray(pest.train(3, log=False, save=False))
        finally:
            del pf.draw_inputs
        np.testing.assert_allclose(pl, jl, **TOL)


def test_model_stream_of_the_estimator(graphs, tmp_path):
    """VGAE's noise comes from `rng_generator(seed, step)`, drawn outside
    the step: a step's noise is the same at K = 1 and 2 and does not
    depend on the flow's draws; evaluate draws step 0's noise anew for
    every batch, so one batch evaluates to one loss twice."""
    jg, pg = graphs[True]
    flow = DeviceGaeFlow(pg, FANOUTS, BATCH, device="cpu")
    cache = DeviceFeatureCache(pg, ["feat"], device="cpu")
    seen = {}
    for k in (1, 2):
        model = GAE(FEAT, DIMS, variational=True)
        draws = []
        orig = model.draw_rngs
        model.draw_rngs = lambda gen, rows, dev: draws.append(orig(gen, rows, dev)) or draws[-1]
        est = Estimator(model, flow, EstimatorConfig(model_dir=str(tmp_path / f"k{k}"),
                                                     steps_per_call=k, **CFG),
                        feature_cache=cache, device="cpu")
        seen[k] = (est.train(3, log=False, save=False), draws)
    assert len(seen[1][1]) == 3
    for a, b in zip(seen[1][1], seen[2][1]):
        assert torch.equal(a["reparam"], b["reparam"])
    np.testing.assert_array_equal(seen[1][0], seen[2][0])
    want = GAE(FEAT, DIMS, variational=True).draw_rngs(rng_generator(CFG["seed"], 1, "cpu"),
                                                      BATCH, "cpu")
    assert torch.equal(seen[1][1][1]["reparam"], want["reparam"])
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(0))
    batch = gae_batches(pg, pflow, BATCH, rng=np.random.default_rng(1))()
    est = Estimator(GAE(FEAT, DIMS, variational=True), lambda: batch,
                    EstimatorConfig(model_dir=str(tmp_path / "e"), **CFG), device="cpu")
    r = est.evaluate([batch, batch])
    assert np.isfinite(r["loss"]) and est.evaluate([batch])["loss"] == r["loss"]


@pytest.mark.parametrize("name", ["vgae", "dgi"])
def test_flax_init_matches_flax(hydrated, name):
    """`params.flax_init` against the JAX Estimator's init at seed 0 (GAE
    declares a "reparam" stream, so its params key comes from a split of
    two; threefry partitionable makes its first key the same): within 2
    ulp."""
    kind = "dgi" if name == "dgi" else "gae"
    jb = hydrated[kind][0]
    jm = MODELS[name][0]()
    names = tuple(getattr(jm, "rng_collections", ()))
    keys = jax.random.split(jax.random.PRNGKey(0), 1 + len(names))
    want = jax.jit(lambda *b: jm.init({"params": keys[0], **dict(zip(names, keys[1:]))}, *b))(*jb)
    got = flax_init(MODELS[name][1](), 0)
    wl = jax.tree_util.tree_leaves(want)
    gl = [to_flax_leaf(k, got[k]) for k in checkpoint_order(got)]
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        np.testing.assert_array_max_ulp(b, np.asarray(a), maxulp=2)


def test_dataclass_replace_keeps_the_batch(graphs):
    """dgi_batches' corrupted batch differs from the real one only in its
    features."""
    _, pg = graphs[True]
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(0))
    real, fake = dgi_batches(pg, pflow, BATCH, rng=np.random.default_rng(1))()
    for f in dataclasses.fields(real):
        if f.name != "feats":
            assert getattr(real, f.name) is getattr(fake, f.name)
