"""The port's ScalableGNN family, the encoders, the aggregators and the
embedding-table functions against the JAX package.

- `HistoryTable`: the port's copy is bitwise the original under `fetch`
  and `update`, repeated ids included.
- `ScalableGNN`: activations, loss and grads within 1e-5 of flax on
  `from_flax` params; `flax_init(raw_key=True)` draws what
  `model.init(PRNGKey(0), batch)` draws.
- `ScalableTrainer` on the two-cluster graph of tests/test_training.py,
  both packages from `default_rng(0)` and JAX's params: bitwise batches,
  the first 5 losses and `histories[1]` within 1e-4 relative; the port
  alone holds the JAX test's rule over 40 steps.
- `SparseEmbedding` (mean and sum, negative ids) and `ShallowEncoder`
  (add and concat, with and without the feature projection, with sparse
  parts): outputs and grads within 1e-5 of flax; the params round-trip
  through `from_flax` and the checkpoint leaves.
- The five aggregators within 1e-5 of flax, grads included.
- The embedding functions bitwise jnp's on unique ids; `embedding_add`
  bitwise on repeated ids too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import ScalableGNN as JaxScalableGNN
from euler_tpu.models import ScalableTrainer as JaxScalableTrainer
from euler_tpu.nn import embedding as jax_embedding
from euler_tpu.nn.aggregators import AGGREGATORS as JAX_AGGREGATORS
from euler_tpu.nn.encoders import ShallowEncoder as JaxShallowEncoder
from euler_tpu.nn.encoders import SparseEmbedding as JaxSparseEmbedding
from euler_tpu.nn.history import HistoryTable as JaxHistoryTable
from euler_tpu_torch.graph import Graph
from euler_tpu_torch.models import ScalableGNN, ScalableTrainer
from euler_tpu_torch.nn import embedding
from euler_tpu_torch.nn.aggregators import AGGREGATORS, get_aggregator
from euler_tpu_torch.nn.encoders import ShallowEncoder, SparseEmbedding
from euler_tpu_torch.nn.history import HistoryTable
from euler_tpu_torch.params import (
    checkpoint_order,
    flax_init,
    from_flax,
    to_checkpoint_leaves,
    to_flax_leaf,
)

torch.set_num_threads(1)

TOL = 1e-5


def cluster_json(n_per=30, seed=0):
    """tests/test_training.py's `make_cluster_graph`: two
    feature-separable clusters with intra-cluster ring edges."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    for c in range(2):
        base = c * n_per
        for i in range(n_per):
            feat = rng.normal(2.0 * (1 if c == 0 else -1), 1.0, 4).tolist()
            label = [1.0, 0.0] if c == 0 else [0.0, 1.0]
            nodes.append({"id": base + i + 1, "type": 0, "weight": 1.0, "features": [
                {"name": "feat", "type": "dense", "value": feat},
                {"name": "label", "type": "dense", "value": label}]})
        for i in range(n_per):
            for d in (1, 2, 3):
                edges.append({"src": base + i + 1, "dst": base + (i + d) % n_per + 1,
                              "type": 0, "weight": 1.0, "features": []})
    return {"nodes": nodes, "edges": edges}


@pytest.fixture(scope="module")
def cluster_graphs():
    return JaxGraph.from_json(cluster_json()), Graph.from_json(cluster_json())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_close(pm, jgrads):
    """The port model's grads, in flax leaf order, within TOL of JAX's."""
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


def assert_flax_init(got, want):
    """`params.flax_init` against flax's draw: each leaf within 3 ulp of its
    largest value (the params.py note: numpy's log1p inside XLA's erf_inv
    rounds to the other neighbour now and then, 1-3 ulp of the normal
    before the lecun scale)."""
    assert got.keys() == want.keys()
    for key in want:
        w = want[key].numpy()
        atol = 3 * float(np.spacing(np.abs(w).max(initial=np.float32(1e-30))))
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=atol, err_msg=key)


def _random_tree(jm, args, rng):
    """Seeded normals in the shapes of flax's init (`jax.eval_shape`: no
    init compiled; the id tables keep their `nn.Partitioned` boxes)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32),
                                  shapes)


def _out_and_probe_grads(jm, tree, args, rng):
    """flax's output, a random probe of its shape, and the grads of
    <output, probe> (a random probe reaches every leaf), in one jitted
    program."""
    probe = rng.normal(size=jax.eval_shape(lambda p: jm.apply(p, *args), tree).shape)
    probe = probe.astype(np.float32)

    @jax.jit
    def fn(tree, probe):
        out, vjp = jax.vjp(lambda p: jm.apply(p, *args), tree)
        return out, vjp(probe)[0]

    out, grads = fn(tree, probe)
    return out, probe, grads


# ---- HistoryTable --------------------------------------------------------


def test_history_table_is_the_original():
    rng = np.random.default_rng(0)
    jt, pt = JaxHistoryTable(20, 3, momentum=0.7), HistoryTable(20, 3, momentum=0.7)
    for _ in range(4):
        ids = rng.integers(-2, 25, 12).astype(np.uint64 if rng.random() < 0.5 else np.int64)
        ids[:3] = ids[3]  # repeated ids: the last write wins in both
        vals = rng.normal(size=(12, 3)).astype(np.float32)
        jt.update(ids, vals)
        pt.update(ids, vals)
        np.testing.assert_array_equal(pt.table, jt.table)
        np.testing.assert_array_equal(pt.fetch(ids), jt.fetch(ids))
    assert pt.table.dtype == np.float32


# ---- ScalableGNN and its trainer -----------------------------------------


def _scalable_batch(rng, b=5, k=3, feat=4, dims=(6, 7)):
    widths = (feat,) + tuple(dims[:-1])
    return {"feats": rng.normal(size=(b, feat)).astype(np.float32),
            "nbr_hist": tuple(rng.normal(size=(b, k, w)).astype(np.float32) for w in widths),
            "nbr_mask": rng.random((b, k)) > 0.3,
            "labels": (rng.random((b, 2)) > 0.5).astype(np.float32)}


def _torch_batch(batch):
    return {k: tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
            else torch.from_numpy(v) for k, v in batch.items()}


def test_scalable_gnn_matches_flax():
    batch = _scalable_batch(np.random.default_rng(1))
    batch["nbr_mask"][0] = False  # a root with no neighbour: the mean over max(count, 1)
    jm = JaxScalableGNN(dims=[6, 7], label_dim=2)
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), batch)
    pm = ScalableGNN(4, [6, 7], 2)
    # flax_init(raw_key=True) is model.init(PRNGKey(0), batch)'s draw
    drawn, want = flax_init(pm, 0, raw_key=True), from_flax(_np_tree(tree))
    assert drawn.keys() == want.keys()
    assert_flax_init(drawn, want)

    def loss_fn(p):
        acts, loss, _, metric = jm.apply(p, batch)
        return loss, (acts, metric)

    (jloss, (jacts, jf1)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm.load_state_dict(want)
    acts, loss, name, f1 = pm(_torch_batch(batch))
    loss.backward()
    assert name == "f1" and len(acts) == 2
    for a, b in zip(acts, jacts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert f1.item() == pytest.approx(float(jf1))
    _grads_close(pm, jgrads)
    assert torch.equal(pm.embed(_torch_batch(batch)), acts[-1].detach())


class _JitInit(JaxScalableGNN):
    """The JAX model with its init jitted: the JAX trainer calls `init`
    eagerly, op by op, each op compiled on its own."""

    def init(self, rngs, *args):
        return jax.jit(lambda r, *a: JaxScalableGNN.init(self, r, *a))(rngs, *args)


def _trainers(graphs, rng_seed=0, **kw):
    jg, pg = graphs
    kw = dict(max_id=64, batch_size=16, fanout=4, learning_rate=0.05, **kw)
    jt = JaxScalableTrainer(jg, _JitInit(dims=[16, 16], label_dim=2), ["feat"],
                            rng=np.random.default_rng(rng_seed), **kw)
    pt = ScalableTrainer(pg, ScalableGNN(4, [16, 16], 2), ["feat"],
                         rng=np.random.default_rng(rng_seed), device="cpu", **kw)
    return jt, pt


def _record_batches(trainer):
    seen, make = [], trainer._make_batch

    def recorded():
        out = make()
        seen.append(out)
        return out

    trainer._make_batch = recorded
    return seen


def test_scalable_trainer_matches_jax(cluster_graphs):
    """Both trainers from default_rng(0), the port's params set first to
    the init JAX draws at its first batch: the batches' roots, masks,
    labels and raw features bitwise, the first 5 losses within 1e-4
    relative (adam's rule), the history rows, histories[1] and the params
    within 1e-4 of their scale (a relu output near 0 carries the absolute
    error of its neighbours)."""
    jt, pt = _trainers(cluster_graphs)
    jseen, pseen = _record_batches(jt), _record_batches(pt)
    rng = np.random.default_rng(9)
    shapes = {"feats": rng.normal(size=(16, 4)).astype(np.float32),
              "nbr_hist": (np.zeros((16, 4, 4), np.float32), np.zeros((16, 4, 16), np.float32)),
              "nbr_mask": np.ones((16, 4), bool), "labels": np.zeros((16, 2), np.float32)}
    tree = jt.model.init(jax.random.PRNGKey(0), shapes)  # JAX's draw: shapes only
    pt.params = from_flax(_np_tree(tree))
    jl, pl = jt.train(5), pt.train(5)
    assert len(jseen) == len(pseen) == 5
    for (jr, jb), (pr, pb) in zip(jseen, pseen):
        np.testing.assert_array_equal(pr, jr)
        for key in ("feats", "nbr_mask", "labels"):
            np.testing.assert_array_equal(pb[key], jb[key])
        np.testing.assert_array_equal(pb["nbr_hist"][0], jb["nbr_hist"][0])
        scale = np.abs(jb["nbr_hist"][1]).max(initial=1.0)
        np.testing.assert_allclose(pb["nbr_hist"][1], jb["nbr_hist"][1], rtol=1e-4,
                                   atol=1e-4 * scale)
    for key, value in from_flax(_np_tree(jt.params)).items():
        np.testing.assert_allclose(pt.params[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    want = jt.histories[1].table
    np.testing.assert_allclose(pt.histories[1].table, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(pt.histories[0].table, 0.0)
    assert all(isinstance(x, float) for x in pl)


def test_scalable_trainer_holds_the_jax_rule(cluster_graphs):
    """tests/test_models.py::test_scalable_trainer on the port alone:
    finite losses, the last below 0.8 x the first, histories refreshed."""
    _, pt = _trainers(cluster_graphs)
    hist = pt.train(40)
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0] * 0.8, (hist[0], hist[-1])
    assert np.abs(pt.histories[1].table).sum() > 0


# ---- encoders ------------------------------------------------------------


def _encoder_inputs(rng, negative=True):
    lo = -7 if negative else 0
    ids = rng.integers(-3, 60, (5, 3)).astype(np.int32)
    sparse = [(rng.integers(lo, 40, (5, 3, 4)).astype(np.int32), rng.random((5, 3, 4)) > 0.4)
              for _ in range(2)]
    sparse[0][1][0, 0] = False  # an empty bag: the mean over max(count, 1)
    dense = rng.normal(size=(5, 3, 6)).astype(np.float32)
    return ids, dense, sparse


ENCODER_CASES = [
    ("sparse", "mean", True), ("sparse", "sum", True),
    ("shallow", "add", True), ("shallow", "concat", True), ("shallow", "add", False),
    ("shallow", "concat", False),
]


@pytest.mark.parametrize("kind,combiner,proj", ENCODER_CASES)
def test_encoders_match_flax(kind, combiner, proj):
    rng = np.random.default_rng(2)
    ids, dense, sparse = _encoder_inputs(rng)
    if kind == "sparse":
        jm, pm = JaxSparseEmbedding(vocab=37, dim=5, combiner=combiner), SparseEmbedding(
            37, 5, combiner=combiner)
        jargs = (sparse[0][0], sparse[0][1])
        pargs = tuple(torch.from_numpy(a) for a in jargs)
    else:
        kw = dict(max_id=50, sparse_vocabs=(37, 11), combiner=combiner, use_feature_proj=proj)
        dim = 5 if proj else 6
        jm, pm = JaxShallowEncoder(dim=dim, **kw), ShallowEncoder(6, dim, **kw)
        jargs = (ids, dense, sparse)
        pargs = (torch.from_numpy(ids), torch.from_numpy(dense),
                 [(torch.from_numpy(i), torch.from_numpy(m)) for i, m in sparse])
    tree = _random_tree(jm, jargs, rng)  # the tables boxed
    # a random probe: grads of <out, probe> reach every leaf
    out, probe, jgrads = _out_and_probe_grads(jm, tree, jargs, rng)
    sd = from_flax(_np_tree(tree))  # from_flax unboxes the id tables' Partitioned boxes
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    got = pm(*pargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    _grads_close(pm, jgrads)
    # the checkpoint leaves are flax's, in its order
    leaves = to_checkpoint_leaves(pm.state_dict())
    for a, b in zip(leaves, jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_shallow_encoder_refuses_no_input():
    with pytest.raises(ValueError, match="at least one input kind"):
        ShallowEncoder(0, 4)(dense=torch.zeros(3, 0))
    with pytest.raises(ValueError, match="at least one input kind"):
        JaxShallowEncoder(dim=4).init(jax.random.PRNGKey(0), dense=jnp.zeros((3, 0)))


# ---- aggregators ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JAX_AGGREGATORS))
def test_aggregators_match_flax(name):
    """The twin of tests/test_utils_extra.py::test_aggregators, held to
    flax's outputs and grads."""
    assert sorted(AGGREGATORS) == sorted(JAX_AGGREGATORS)
    rng = np.random.default_rng(4)
    self_x = rng.normal(size=(4, 6)).astype(np.float32)
    nbr = rng.normal(size=(4, 5, 6)).astype(np.float32)
    mask = rng.random((4, 5)) > 0.3
    mask[1] = False  # a row with no neighbour
    jm = JAX_AGGREGATORS[name](dim=8)
    tree = _random_tree(jm, (self_x, nbr, mask), rng)
    out, probe, jgrads = _out_and_probe_grads(jm, tree, (self_x, nbr, mask), rng)
    pm = get_aggregator(name)(6, 8)
    pm.load_state_dict(from_flax(_np_tree(tree)))
    got = pm(torch.from_numpy(self_x), torch.from_numpy(nbr), torch.from_numpy(mask))
    assert got.shape == (4, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    _grads_close(pm, jgrads)
    with pytest.raises(KeyError, match="unknown aggregator"):
        get_aggregator("nope")


# ---- embedding functions -------------------------------------------------


def test_embedding_functions_match_jnp():
    """tests/test_parity_extras.py's cases, and the five functions on
    random tables: bitwise jnp's (unique ids; add on repeated ids too).
    The scatters run as one jitted program (op by op, each would compile
    on its own); the moving averages run eagerly, as jnp's ops (under jit
    XLA fuses m·old + (1-m)·v into one rounding)."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(12, 4)).astype(np.float32)
    ids = np.array([0, 4, 7, 11], np.int64)
    vals = rng.normal(size=(4, 4)).astype(np.float32)
    rep = np.array([2, 5, 2, 2, 9], np.int64)
    rep_vals = rng.normal(size=(5, 4)).astype(np.float32)
    lookup = np.array([0, 4, 7, 11, 4], np.int64)
    je = jax_embedding

    def parts(x):
        return [x[p::3] for p in range(3)]

    @jax.jit
    def scatters(table):
        return (je.embedding_update(table, ids, vals), je.embedding_add(table, ids, vals),
                je.embedding_add(table, rep, rep_vals), je.partitioned_lookup(parts(table), lookup),
                *(je.partitioned_update(parts(table), ids, vals, func=f)
                  for f in (je.embedding_update, je.embedding_add)))

    jt = jnp.asarray(table)
    want = [*scatters(jt), je.embedding_moving_average(jt, ids, vals, 0.75),
            je.partitioned_update(parts(jt), ids, vals, func=je.embedding_moving_average,
                                  momentum=0.6)]
    t, v = torch.from_numpy(table), torch.from_numpy(vals)
    tables = [torch.from_numpy(table[p::3].copy()) for p in range(3)]
    got = [embedding.embedding_update(t, ids, v), embedding.embedding_add(t, ids, v),
           embedding.embedding_add(t, rep, torch.from_numpy(rep_vals)),
           embedding.partitioned_lookup(tables, lookup),
           *(embedding.partitioned_update(tables, ids, v, func=f)
             for f in (embedding.embedding_update, embedding.embedding_add)),
           embedding.embedding_moving_average(t, ids, v, 0.75),
           embedding.partitioned_update(tables, ids, v, func=embedding.embedding_moving_average,
                                        momentum=0.6)]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t.numpy(), table)  # functional: the input stays
    with pytest.raises(ValueError, match="partitioned_update supports"):
        embedding.partitioned_update(tables, ids, v, func=max)
