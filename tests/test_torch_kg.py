"""The port's knowledge-graph family and the host copies it needs, against
the JAX package: `build_from_json` / `Graph.from_json` / `convert_json`
(every array bitwise), the dataset catalog and quality stand-ins
(`cora_like_json`, `fb15k_like`: equal graph.json), all six `TransX`
variants (the init's structure and projection values, then loss, metric
and grads within 1e-5 on `from_flax` params, `norm_ord` 1 and 2),
`kg_batches` bitwise, `DeviceKGFlow` fed JAX's draws bitwise,
`kg_rank_eval`'s ranks bitwise, `kg_ranking_metrics` (filtered and raw)
equal, `transx_warm_start`, and a few Estimator steps of TransE within
1e-4 of JAX's losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import DeviceKGFlow as JaxDeviceKGFlow
from euler_tpu.datasets import get_dataset as jax_get_dataset
from euler_tpu.datasets.quality import cora_like_json as jax_cora_like
from euler_tpu.datasets.quality import fb15k_like as jax_fb15k_like
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.graph.builder import build_from_json as jax_build_from_json
from euler_tpu.models import TransX as JaxTransX
from euler_tpu.models import kg_batches as jax_kg_batches
from euler_tpu.models import kg_rank_eval as jax_kg_rank_eval
from euler_tpu.models import kg_ranking_metrics as jax_kg_ranking_metrics
from euler_tpu.models import transx_warm_start as jax_warm_start
from euler_tpu_torch.dataflow import DeviceKGFlow
from euler_tpu_torch.datasets import cora_like_json, fb15k_like, get_dataset
from euler_tpu_torch.datasets.catalog import KGDataset, PlanetoidDataset
from euler_tpu_torch.estimator import Estimator, EstimatorConfig
from euler_tpu_torch.graph import Graph, build_from_json, convert_json, read_arrays
from euler_tpu_torch.models import TransX, kg_batches, kg_rank_eval, kg_ranking_metrics
from euler_tpu_torch.models import transx_warm_start
from euler_tpu_torch.models.kg import VARIANTS, kg_rank_ranks
from euler_tpu_torch.params import checkpoint_order, from_flax, init_like_flax, to_flax_leaf

torch.set_num_threads(1)

N_ENT, N_REL = 60, 4


@pytest.fixture(scope="module")
def kg():
    """A small fb15k_like graph in both packages (weighted edges: the
    flat edge CDF is staged) and its test triples."""
    j, test = jax_fb15k_like(n_ent=N_ENT, n_rel=N_REL, dim=4, n_train=400, n_test=24, seed=1)
    for i, e in enumerate(j["edges"]):
        e["weight"] = 1.0 + i % 3
    for i, nd in enumerate(j["nodes"]):
        nd["weight"] = 1.0 + i % 2
    return JaxGraph.from_json(j), Graph.from_json(j), test


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


def _same_dict(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        _same(np.asarray(want[k]), got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k])


# ---- builder, datasets, stand-ins -----------------------------------------


@pytest.mark.parametrize("parts", [1, 2])
def test_builder_matches_jax(fixture_graph_dict, parts, tmp_path):
    """Every array of every shard (dense, sparse and binary features,
    graph labels, in-edges) and the meta, bitwise; convert_json writes
    what the JAX reader loads."""
    jmeta, jarrays = jax_build_from_json(fixture_graph_dict, parts)
    pmeta, parrays = build_from_json(fixture_graph_dict, parts)
    assert pmeta.to_dict() == jmeta.to_dict()
    for ja, pa in zip(jarrays, parrays):
        assert sorted(ja) == sorted(pa)
        for k in ja:
            _same(ja[k], pa[k])
    convert_json(fixture_graph_dict, str(tmp_path), parts)
    jg = JaxGraph.load(str(tmp_path), native=False)
    for p, sh in enumerate(jg.shards):
        disk = read_arrays(str(tmp_path / f"part_{p}"))
        for k in parrays[p]:
            _same(parrays[p][k], disk[k])
        _same(sh.node_ids, parrays[p]["node_ids"])


def test_catalog_and_stand_ins_match_jax(tmp_path):
    assert get_dataset("cora").synthetic_json() == jax_get_dataset("cora").synthetic_json()
    assert get_dataset("fb15k").synthetic_json(3) == jax_get_dataset("fb15k").synthetic_json(3)
    assert get_dataset("mutag").synthetic_json() == jax_get_dataset("mutag").synthetic_json()
    for name in ("ppi", "ml_1m"):
        with pytest.raises(NotImplementedError, match="item 4"):
            get_dataset(name)
    with pytest.raises(KeyError):
        get_dataset("nope")
    kw = dict(num_nodes=150, num_classes=3, feature_dim=40, train_per_class=5, val_n=30,
              test_n=40, seed=2)
    assert cora_like_json(**kw) == jax_cora_like(**kw)
    fkw = dict(n_ent=50, n_rel=3, dim=4, n_train=120, n_test=9, seed=3)
    for projective in (False, True):
        (jj, jt), (pj, pt) = jax_fb15k_like(**fkw, projective=projective), fb15k_like(
            **fkw, projective=projective)
        assert pj == jj
        _same(jt, pt)
    # the pipeline: convert once into the cache dir, load, split by type
    ds = PlanetoidDataset("cora", root=str(tmp_path / "cora"))
    g = ds.load_graph(synthetic=True)
    jds = jax_get_dataset("cora", root=str(tmp_path / "cora"))
    jg = jds.load_graph(synthetic=True)
    for k, v in jds.splits(jg).items():
        _same(v, ds.splits(g)[k])
    with pytest.raises(FileNotFoundError):
        KGDataset("fb15k", root=str(tmp_path / "none")).load_graph()


# ---- the model -----------------------------------------------------------


def _batch(rng, b=10, n=3):
    return {"h": rng.integers(-1, N_ENT + 2, b).astype(np.int32),
            "r": rng.integers(0, N_REL, b).astype(np.int32),
            "t": rng.integers(1, N_ENT + 1, b).astype(np.int32),
            "neg_h": rng.integers(1, N_ENT + 1, (b, n)).astype(np.int32),
            "neg_t": rng.integers(1, N_ENT + 1, (b, n)).astype(np.int32)}


def _unbox(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x.unbox() if hasattr(x, "unbox") else x),
                                  tree, is_leaf=lambda x: hasattr(x, "unbox"))


def _init(model, batch, seed=0):
    """A flax init (jitted: one program, not op by op) as numpy leaves."""
    return _unbox(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                      jax.tree_util.tree_map(jnp.asarray, batch)))


def _tree(model, batch, seed=0, init=None):
    """A flax init as numpy leaves; the tables scaled (and TransX's
    projections perturbed) so scores spread."""
    tree = _init(model, batch, seed) if init is None else init
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x * 10.0 + rng.normal(0, 0.05, x.shape)).astype(np.float32), tree)


CASES = [(v, 2) for v in VARIANTS] + [("transe", 1), ("transr", 1)]


@pytest.mark.parametrize("variant,norm_ord", CASES)
def test_transx_loss_metric_and_grads_match_jax(variant, norm_ord):
    batch = _batch(np.random.default_rng(4))
    kw = dict(num_entities=N_ENT, num_relations=N_REL, dim=6, variant=variant,
              norm_ord=norm_ord, rel_dim=8 if variant in ("transr", "transd") else 0)
    jm = JaxTransX(**kw)
    init = _init(jm, batch)
    pm = TransX(**kw)
    # the init's structure, and the projections' identity / zero rows
    want = from_flax(init)
    got = init_like_flax(pm, torch.Generator().manual_seed(0))
    assert sorted(want) == sorted(got)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k.split(".")[0] in ("proj", "ent_proj", "rel_proj"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    tree = _tree(jm, batch, init=init)

    def loss_fn(p):
        _, loss, _, metric = jm.apply(p, jax.tree_util.tree_map(jnp.asarray, batch))
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm.load_state_dict(from_flax(tree))
    _, loss, name, metric = pm({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert name == "mrr"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metric.item(), float(jmetric), rtol=1e-5, atol=1e-5)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["transe", "rotate"])
def test_rank_eval_ranks_match_jax(kg, variant):
    """kg_rank_eval's ranks bitwise (computed as JAX's kg_rank_eval
    computes them), its means equal, and kg_ranking_metrics equal in the
    filtered and the raw setting."""
    jg, pg, test = kg
    kw = dict(num_entities=N_ENT, num_relations=N_REL, dim=8, variant=variant)
    jm = JaxTransX(**kw)
    tree = _tree(jm, _batch(np.random.default_rng(5)), seed=3)
    pm = TransX(**kw)
    pm.load_state_dict(from_flax(tree))
    all_ents = jnp.arange(1, N_ENT + 1, dtype=jnp.int32)

    @jax.jit
    def jax_ranks(h, r, t):  # kg_rank_eval's scores_for, then its rank
        pos = jm.apply(tree, h, r, t, method=jm.score_triples)
        b = h.shape[0]
        neg = jm.apply(tree, jnp.broadcast_to(h[:, None], (b, N_ENT)),
                       jnp.broadcast_to(r[:, None], (b, N_ENT)),
                       jnp.broadcast_to(all_ents[None, :], (b, N_ENT)), method=jm.score_triples)
        return 1 + jnp.sum((neg > pos[:, None]).astype(jnp.int32), axis=1)

    want = np.concatenate([np.asarray(jax_ranks(*(jnp.asarray(test[i:i + 8, j])
                                                   for j in range(3))))
                           for i in range(0, len(test), 8)]).astype(np.float64)
    _same(want, kg_rank_ranks(pm, None, test, N_ENT, batch=8))
    assert kg_rank_eval(pm, None, test, N_ENT, batch=8) == jax_kg_rank_eval(
        jm, tree, test, N_ENT, batch=8)
    train = np.stack([pg.shards[0].edge_src, pg.shards[0].edge_types,
                      pg.shards[0].edge_dst], axis=1).astype(np.int64)
    for filt in (train, None):
        assert kg_ranking_metrics(pm, from_flax(tree), test[:10], N_ENT, filt, batch=4) == \
            jax_kg_ranking_metrics(jm, tree, test[:10], N_ENT, filt, batch=4)


def test_warm_start_matches_jax(kg):
    batch = _batch(np.random.default_rng(6))
    src = JaxTransX(N_ENT, N_REL, dim=6, variant="transe")
    trained = _tree(src, batch, seed=7)
    for variant in ("transr", "transd"):
        jm = JaxTransX(N_ENT, N_REL, dim=6, variant=variant)
        # one program (the init op by op would compile each op)
        warm = jax.jit(lambda t, b: jax_warm_start(jm, t, b))
        want = from_flax(_unbox(warm(trained, jax.tree_util.tree_map(jnp.asarray, batch))))
        pm = TransX(N_ENT, N_REL, dim=6, variant=variant)
        got = transx_warm_start(pm, from_flax(trained))
        assert sorted(got) == sorted(want)
        for k in ("entity.table", "relation.table") + tuple(
                k for k in want if k.split(".")[0] in ("proj", "ent_proj", "rel_proj")):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert torch.equal(transx_warm_start(pm, trained)["entity.table"], got["entity.table"])


# ---- batch sources -------------------------------------------------------


def test_kg_batches_match_jax(kg, tmp_path):
    jg, pg, _ = kg
    for et in (-1, 2):
        jf = jax_kg_batches(jg, 12, 3, et, rng=np.random.default_rng(8))
        pf = kg_batches(pg, 12, 3, et, rng=np.random.default_rng(8))
        for _ in range(2):
            _same_dict(jf()[0], pf()[0])


def kg_draws(jf, key):
    """JAX's DeviceKGFlow.sample(key) draws: edge picks, corruption rows."""
    kedge, kneg = jax.random.split(key)
    pick = np.asarray(jf._draw_edges(kedge, jf.batch_size)).astype(np.int64)
    negs = np.asarray(jf._draw_global_nodes(kneg, jf.batch_size * jf.num_negs * 2))
    return torch.from_numpy(pick), torch.from_numpy(negs.copy())


@pytest.mark.parametrize("edge_type", [-1, 1])
def test_kg_flow_matches_jax(kg, edge_type):
    jg, pg, _ = kg
    jf, pf = JaxDeviceKGFlow(jg, 12, 3, edge_type), DeviceKGFlow(pg, 12, 3, edge_type,
                                                                   device="cpu")
    assert jf.num_edges == pf.num_edges
    for name in ("eh", "et", "er", "node_id", "global_cdf", "edge_cdf"):
        a, b = np.asarray(getattr(jf, name)), getattr(pf, name).numpy()
        np.testing.assert_array_equal(b, a.astype(np.int64) if a.dtype == np.uint32 else a)
    sample = jax.jit(jf.sample)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        _same_dict(sample(key), pf.make_batch(*kg_draws(jf, key)))
    # the port's own draws: real triples, negatives over every entity
    b = pf.sample(torch.Generator().manual_seed(0))
    triples = set(zip(pg.shards[0].edge_src.tolist(), pg.shards[0].edge_types.tolist(),
                      pg.shards[0].edge_dst.tolist()))
    assert all(t in triples for t in zip(b["h"].tolist(), b["r"].tolist(), b["t"].tolist()))


# ---- Estimator steps -----------------------------------------------------


def test_transe_estimator_matches_jax(kg, tmp_path):
    """4 adam steps on the same host batches from one flax init, then
    the trained tables' ranks through kg_rank_eval."""
    jg, pg, test = kg
    cfg = dict(learning_rate=0.05, log_steps=10**9, seed=3)
    src = jax_kg_batches(jg, 16, 4, rng=np.random.default_rng(9))
    batches = [src() for _ in range(5)]  # one more: JAX initialises from a draw
    jm = JaxTransX(N_ENT, N_REL, dim=8)
    tree = _tree(jm, batches[0][0], seed=1)
    jit = iter(batches)
    jest = JaxEstimator(jm, lambda: next(jit), JaxConfig(model_dir=str(tmp_path / "j"), **cfg),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jl = np.asarray(jest.train(4, log=False, save=False))
    pit = iter(batches)
    pest = Estimator(TransX(N_ENT, N_REL, dim=8), lambda: next(pit),
                     EstimatorConfig(model_dir=str(tmp_path / "p"), **cfg),
                     init_params=from_flax(tree), device="cpu")
    pl = np.asarray(pest.train(4, log=False, save=False))
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    ev = pest.evaluate([batches[0]])
    assert sorted(ev) == ["loss", "mrr"]
    r = kg_rank_eval(pest.model, None, test, N_ENT)
    assert 1 <= r["mean_rank"] <= N_ENT and 0 < r["mrr"] <= 1
