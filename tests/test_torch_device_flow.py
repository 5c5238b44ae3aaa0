"""euler_tpu_torch DeviceSageFlow against the JAX package's: the staged
tables are equal, and `make_batch` fed the random numbers JAX derives
from its key gives JAX's `sample(key)` MiniBatch leaf for leaf, bitwise —
dense and paged layouts, weighted and unit-weight graphs, page sizes 8
and 16, f32 and packed bf16 weight planes, and a hub graph whose rows
span many pages. The port's own generator is held to the weight
distribution on a hub.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.graph.builder import build_from_json
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import DeviceSageFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import Graph, GraphMeta, GraphStore

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
                    layout=layout, page_size=page_size)
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
