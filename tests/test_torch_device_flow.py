"""euler_tpu_torch DeviceSageFlow against the JAX package's: the staged
tables are equal, and `make_batch` fed the random numbers JAX derives
from its key gives JAX's `sample(key)` MiniBatch leaf for leaf, bitwise —
dense and paged layouts, weighted and unit-weight graphs, page sizes 8
and 16, f32 and packed bf16 weight planes (with hop ids), and a hub
graph whose rows span many pages. The port's own generator is held to
the weight distribution on a hub.

The id-embedding GraphSAGE: hop ids are the sampled rows' ids (-1 on pad
rows, whose hydrated masks are False), DGI's id plane rides its rows'
permutation, `to_device` moves a host batch's hop ids so that each
replay of a captured step reads its own batch's ids, and
GraphSAGESupervised(encoder_dim=8, max_id=300) gives JAX's loss and
grads within 1e-5 and trains through the Estimator at steps_per_call 2-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.dataflow.base import hydrate_blocks as jax_hydrate_blocks
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.graph.builder import build_from_json
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGESupervised
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import DeviceDgiFlow, DeviceSageFlow, SageDataFlow, hydrate_blocks
from euler_tpu_torch.dataflow.base import to_device
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
from euler_tpu_torch.estimator.graph_step import signature, tensor_leaves, with_leaves
from euler_tpu_torch.graph import Graph, GraphMeta, GraphStore
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import checkpoint_order, from_flax, to_flax_leaf

torch.set_num_threads(1)

FANOUTS, BATCH = [4, 3], 16


def _hub_json(n: int = 60, hub_deg: int = 40):
    """One hub with degree >> page size, everyone else on a ring; node
    weights vary, so roots are drawn through the node CDF (the graph of
    tests/test_paged_flow.py with non-uniform node weights)."""
    nodes = [
        {"id": i, "type": 0, "weight": 1.0 + i % 3,
         "features": [
             {"name": "feat", "type": "dense", "value": [float(i % 3), 1.0]},
             {"name": "label", "type": "dense", "value": [float(i % 2), float(1 - i % 2)]},
         ]}
        for i in range(n)
    ]
    edges = [
        {"src": 0, "dst": 1 + (j % (n - 1)), "type": 0, "weight": 1.0 + j % 5, "features": []}
        for j in range(hub_deg)
    ]
    edges += [
        {"src": i, "dst": (i + 1) % n, "type": 0, "weight": 2.0 if i % 2 else 1.0, "features": []}
        for i in range(1, n)
    ]
    return {"nodes": nodes, "edges": edges}


def _hub_graphs(n=60, hub_deg=40):
    meta, arrays = build_from_json(_hub_json(n, hub_deg), 1)
    jg = JaxGraph.from_json(_hub_json(n, hub_deg))
    pmeta = GraphMeta.from_dict(meta.to_dict())
    return jg, Graph(pmeta, [GraphStore(pmeta, a, p) for p, a in enumerate(arrays)])


def _random_graphs(weighted):
    kw = dict(num_nodes=300, out_degree=6, feat_dim=8, seed=3, weighted=weighted)
    return jax_random_graph(**kw), random_graph(**kw)


def _flows(jg, pg, **kw):
    return (JaxDeviceSageFlow(jg, **kw),
            DeviceSageFlow(pg, **kw, device="cpu"))


def jax_draws(jflow, key):
    """The random numbers JAX's `sample(key)` draws (device.py:1070-1075
    and :1033): the root rows, then per hop u32 bits or f32 uniforms."""
    kroot, khops = jax.random.split(key)
    roots = np.asarray(jflow._draw_roots(kroot, jflow.batch_size))
    draws, width = [], jflow.batch_size
    for k, hk in zip(jflow.fanouts, jax.random.split(khops, len(jflow.fanouts))):
        if jflow.unit_w:
            draws.append(np.asarray(jax.random.uniform(hk, (width, k))))
        else:
            bits = np.asarray(jax.random.bits(hk, (width, k), dtype=jnp.uint32))
            draws.append(bits.view(np.int32))
        width *= k
    return torch.from_numpy(roots.copy()), tuple(torch.from_numpy(d.copy()) for d in draws)


def _np(x):
    """A leaf as comparable bits: bf16 as its uint16 pattern."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def assert_same_batch(jb, pb):
    assert jb.masks is None and pb.masks is None
    assert len(jb.feats) == len(pb.feats) and len(jb.blocks) == len(pb.blocks)
    pairs = [(a, b) for a, b in zip(jb.feats, pb.feats)]
    pairs += [(jb.root_idx, pb.root_idx), (jb.labels, pb.labels)]
    assert (jb.hop_ids is None) == (pb.hop_ids is None)
    if jb.hop_ids is not None:
        pairs += list(zip(jb.hop_ids, pb.hop_ids, strict=True))
    for a, b in zip(jb.blocks, pb.blocks):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        assert b.edge_src is None and b.mask is None
        assert (a.edge_w is None) == (b.edge_w is None)
        if a.edge_w is not None:
            pairs.append((a.edge_w, b.edge_w))
    for a, b in pairs:
        want, got = _np(a), _np(b)
        assert want.dtype == got.dtype and want.shape == got.shape
        np.testing.assert_array_equal(got, want)


def assert_same_tables(jf, pf):
    assert jf.layout == pf.layout and jf.unit_w == pf.unit_w and jf.max_deg == pf.max_deg
    names = ["deg", "node_id"]
    if jf.layout == "dense":
        names += ["adj"] + ([] if jf.unit_w else ["qtab", "wtab"])
    else:
        names += ["pages2d", "page_start"] + ([] if jf.unit_w else ["page_q2d", "page_w2d"])
        assert (jf.page_size, jf.max_pages, jf._search_iters) == (
            pf.page_size, pf.max_pages, pf._search_iters
        )
        assert jf._page_w_packed == pf._page_w_packed
        if not jf.unit_w:
            np.testing.assert_array_equal(pf.page_bound.numpy(), np.asarray(jf.page_bound))
    for name in names:
        want, got = np.asarray(getattr(jf, name)), getattr(pf, name).numpy()
        assert want.shape == got.shape, name
        np.testing.assert_array_equal(got.view(np.uint32) if want.dtype == np.uint32 else got,
                                      want, err_msg=name)
    for name in ("node_cdf", "roots"):
        a, b = getattr(jf, name), getattr(pf, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


CASES = [
    ("dense", False, 16, "f32"),
    ("dense", True, 16, "f32"),
    ("paged", False, 8, "f32"),
    ("paged", True, 8, "f32"),
    ("paged", True, 16, "f32"),
    ("paged", True, 16, "bf16"),
]


@pytest.mark.parametrize("layout,weighted,page_size,plane", CASES)
def test_tables_and_batches_match_jax(layout, weighted, page_size, plane, monkeypatch):
    monkeypatch.setenv("EULER_TPU_PAGE_DTYPE", plane)
    jg, pg = _random_graphs(weighted)
    jf, pf = _flows(jg, pg, fanouts=FANOUTS, batch_size=BATCH, label_feature="label",
                    layout=layout, page_size=page_size, with_hop_ids=True)
    assert_same_tables(jf, pf)
    if layout == "paged":
        assert pf._page_w_packed == (weighted and plane == "bf16")
    sample = jax.jit(jf.sample)
    for t in range(2):
        key = jax.random.PRNGKey(t)
        assert_same_batch(sample(key), pf.make_batch(*jax_draws(jf, key)))


def test_two_shard_graph_matches_jax():
    """Rows are shard-major over both shards, in both packages."""
    kw = dict(num_nodes=200, out_degree=5, feat_dim=4, seed=9, weighted=True, num_partitions=2)
    jf, pf = _flows(jax_random_graph(**kw), random_graph(**kw), fanouts=[3, 2],
                    batch_size=8, label_feature="label", layout="paged")
    assert_same_tables(jf, pf)
    key = jax.random.PRNGKey(4)
    assert_same_batch(jax.jit(jf.sample)(key), pf.make_batch(*jax_draws(jf, key)))


@pytest.mark.parametrize("plane", ["f32", "bf16"])
def test_hub_graph_multi_page_rows_match_jax(plane, monkeypatch):
    """Hub rows span 5 pages of 8 slots: the two-level search and the
    in-page count give JAX's draws; roots come through the node CDF."""
    monkeypatch.setenv("EULER_TPU_PAGE_DTYPE", plane)
    jg, pg = _hub_graphs()
    jf, pf = _flows(jg, pg, fanouts=[5, 2], batch_size=32, label_feature="label",
                    layout="paged", page_size=8)
    assert pf.max_pages >= 5 and pf.node_cdf is not None
    assert_same_tables(jf, pf)
    sample = jax.jit(jf.sample)
    for t in range(2):
        key = jax.random.PRNGKey(t)
        assert_same_batch(sample(key), pf.make_batch(*jax_draws(jf, key)))


def test_kernel_modes_agree_on_cpu():
    """Modes 'off', 'ref' and 'auto' all run the plain versions on CPU
    tensors: the same batch, and no kernel launch."""
    _, pg = _random_graphs(True)
    pf = DeviceSageFlow(pg, fanouts=FANOUTS, batch_size=BATCH, layout="paged", device="cpu")
    before = ops.launch_counts()
    batches = []
    try:
        for mode in ("off", "ref", "auto"):
            ops.set_kernel_mode(mode)
            batches.append(pf.sample(torch.Generator().manual_seed(5)))
    finally:
        ops.set_kernel_mode("auto")
    assert ops.launch_counts() == before
    for b in batches[1:]:
        for x, y in zip(batches[0].feats + (batches[0].blocks[1].edge_w,),
                        b.feats + (b.blocks[1].edge_w,)):
            assert torch.equal(x, y)


def test_auto_layout_picks_paged_past_the_guard():
    _, pg = _hub_graphs(n=50, hub_deg=40)
    flow = DeviceSageFlow(pg, fanouts=[3], batch_size=8, max_degree=8, device="cpu")
    assert flow.layout == "paged"
    assert DeviceSageFlow(pg, fanouts=[3], batch_size=8, device="cpu").layout == "dense"
    with pytest.raises(ValueError, match="paged"):
        DeviceSageFlow(pg, fanouts=[3], batch_size=8, max_degree=8, layout="dense", device="cpu")


def test_root_restrictions_stage_like_jax():
    """roots_pool and root_node_type restrict the root rows (with the
    pool's weights in the node CDF), as the JAX flow stages them."""
    jg, pg = _hub_graphs(n=30, hub_deg=12)
    pool = np.array([3, 0, 7, 11], np.uint64)
    for kw in ({"roots_pool": pool}, {"root_node_type": 0}):
        jf, pf = _flows(jg, pg, fanouts=[3], batch_size=8, **kw)
        assert_same_tables(jf, pf)
        roots = pf.draw_inputs(torch.Generator().manual_seed(0))[0]
        assert torch.isin(roots, pf.roots).all()
    with pytest.raises(ValueError, match="no nodes of type 1"):
        DeviceSageFlow(pg, fanouts=[3], batch_size=8, root_node_type=1, device="cpu")


def test_hub_draws_follow_edge_weights():
    """The port's own generator: hub draws through the paged two-level
    CDF are proportional to the edge weights (tests/test_paged_flow.py
    test_paged_weighted_hub_distribution)."""
    _, pg = _hub_graphs(n=40, hub_deg=35)
    hub = np.array([0], np.uint64)
    hub_row = int(pg.lookup_rows(hub)[0])
    flow = DeviceSageFlow(pg, fanouts=[64], batch_size=64, layout="paged", page_size=8,
                          roots_pool=hub, device="cpu")
    nbr, w, _, m, _ = pg.get_full_neighbor(hub)
    w_of = {}
    for a, b in zip(nbr[0][m[0]], w[0][m[0]]):
        w_of[int(a)] = w_of.get(int(a), 0.0) + float(b)
    ids = pg.shards[0].node_ids
    counts = {}
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        mb = flow.sample(gen)
        assert torch.all(mb.feats[0] == hub_row + 1)
        for nid in ids[mb.feats[1].numpy() - 1]:
            counts[int(nid)] = counts.get(int(nid), 0) + 1
    total = sum(counts.values())
    assert total == 20 * 64 * 64
    for nid, cnt in counts.items():
        assert abs(cnt / total - w_of[nid] / sum(w_of.values())) < 0.05, nid


# ---- hop ids and the id-embedding GraphSAGE ----------------------------------


def test_hop_ids_are_the_rows_ids():
    """Each hop's ids are the ids of its rows, -1 on pad rows, whose
    hydrated masks are False (so a pad slot's embedding never reaches the
    aggregation); DGI's corrupted batch permutes the id plane with its
    rows."""
    graph = _hub_json()
    # every fifth ring node has no out-edge: its fanout slots are pad rows
    graph["edges"] = [e for e in graph["edges"] if e["src"] == 0 or e["src"] % 5]
    pg = Graph.from_json(graph)
    ids = pg.shards[0].node_ids
    node_id = np.full(len(ids) + 1, -1, np.int32)
    node_id[1:] = ids.astype(np.int64).astype(np.int32)
    flow = DeviceSageFlow(pg, fanouts=[4, 3], batch_size=16, label_feature="label",
                          with_hop_ids=True, layout="paged", page_size=8, device="cpu")
    mb = flow.sample(torch.Generator().manual_seed(0))
    hb = hydrate_blocks(mb)
    assert len(mb.hop_ids) == 3
    for h, (rows, ids) in enumerate(zip(mb.feats, mb.hop_ids)):
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), node_id[rows.numpy()])
        if h:
            assert torch.equal(hb.masks[h], rows > 0)
    assert (mb.feats[2] == 0).any()  # the ring's rows pad past their degree
    dgi = DeviceDgiFlow(pg, fanouts=[4], batch_size=16, with_hop_ids=True, device="cpu")
    real, fake = dgi.sample(torch.Generator().manual_seed(1))
    assert not torch.equal(real.hop_ids[1], fake.hop_ids[1])
    for b in (real, fake):
        for rows, ids in zip(b.feats, b.hop_ids):
            np.testing.assert_array_equal(ids.numpy(), node_id[rows.numpy()])


def test_to_device_moves_hop_ids_for_each_replay():
    """A non-lean host batch's hop ids become int32 tensors, so a captured
    step (StepGraph copies new inputs into the tensor leaves it captured)
    embeds each replay's own ids; host ids would stay baked in as the
    first batch's."""
    _, pg = _random_graphs(True)
    flow = SageDataFlow(pg, ["feat"], fanouts=[3, 2], label_feature="label",
                        rng=np.random.default_rng(0))
    b1, b2 = (to_device(flow.query(pg.sample_node(8, rng=np.random.default_rng(s))), "cpu")
              for s in (1, 2))
    for b in (b1, b2):
        assert all(isinstance(h, torch.Tensor) and h.dtype == torch.int32 for h in b.hop_ids)
    assert signature(b1) == signature(b2)
    torch.manual_seed(0)
    model = GraphSAGESupervised(8, [8, 8], 2, encoder_dim=8, max_id=300)
    static = [t.clone() for t in tensor_leaves(b1)]
    captured = with_leaves(b1, iter(static))
    for s, t in zip(static, tensor_leaves(b2)):  # a replay's input copy
        s.copy_(t)
    for h, ids in enumerate(b2.hop_ids):
        assert torch.equal(captured.hop_ids[h], ids)
    with torch.no_grad():
        got, want, first = model.embed(captured), model.embed(b2), model.embed(b1)
    assert torch.equal(got, want) and not torch.equal(got, first)


def _encoder_tree(module, batch, seed):
    """Seeded normals in the shapes of the flax tree (the id table and
    the Denses at a quarter of lecun's scale): no flax init compiled."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), batch)
    import flax.linen as nn

    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0
        std = 0.25 * fan_in**-0.5 if 4 < fan_in < 300 else 0.1
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(leaf, nn.meta.unbox(shapes))


def test_encoder_stage_matches_jax(tmp_path):
    """GraphSAGESupervised(encoder_dim=8, max_id=300) on one hydrated
    device-flow batch with hop ids (fed JAX's draws): loss, metric and
    grads within 1e-5 of flax's, the id table's among them; then the
    Estimator trains on the port's flow at steps_per_call 2 and 4."""
    jg, pg = _random_graphs(True)
    jf, pf = _flows(jg, pg, fanouts=[3, 2], batch_size=8, label_feature="label",
                    layout="paged", page_size=8, with_hop_ids=True)
    jc, pc = JaxFeatureCache(jg, ["feat"]), DeviceFeatureCache(pg, ["feat"], device="cpu")
    key = jax.random.PRNGKey(3)
    jb = jax.jit(lambda k: jc.hydrate(jax_hydrate_blocks(jf.sample(k))))(key)
    pb = pc.hydrate(hydrate_blocks(pf.make_batch(*jax_draws(jf, key))))
    jm = JaxGraphSAGESupervised(dims=[8, 8], label_dim=2, encoder_dim=8, max_id=300)
    tree = _encoder_tree(jm, jb, 1)
    assert tree["params"]["net"]["encoder"]["Embedding_0"]["table"].shape == (384, 8)

    def loss_fn(p):
        _, loss, _, metric = jm.apply(p, jb)
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    pm = GraphSAGESupervised(8, [8, 8], 2, encoder_dim=8, max_id=300)
    sd = from_flax(jax.tree_util.tree_map(np.asarray, tree))
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    _, loss, _, metric = pm(pb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metric.item(), float(jmetric), rtol=1e-5, atol=1e-5)
    named = dict(pm.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    assert np.abs(got[checkpoint_order(named).index("net.encoder.Embedding_0.table")]).sum() > 0
    for k in (2, 4):
        est = Estimator(GraphSAGESupervised(8, [8, 8], 2, encoder_dim=8, max_id=300), pf,
                        EstimatorConfig(model_dir=str(tmp_path / f"k{k}"), learning_rate=0.05,
                                        log_steps=10**9, steps_per_call=k),
                        feature_cache=pc, device="cpu")
        losses = est.train(total_steps=8, log=False, save=False)
        assert len(losses) == 8 and np.isfinite(losses).all()
