"""euler_tpu_torch graph store, synthetic data and SageDataFlow against the
JAX package: the same graph dir and the same numpy seeds give
bit-identical arrays."""

import os

import numpy as np
import pytest
import torch

from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu_torch.dataflow import SageDataFlow, to_device
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import DEFAULT_ID, Graph, write_arrays
from euler_tpu_torch.graph import meta as port_meta

torch.set_num_threads(1)

NODES, DEGREE, FEAT = 300, 5, 12


def _write(graph, directory):
    for p, shard in enumerate(graph.shards):
        write_arrays(os.path.join(directory, f"part_{p}"), shard.arrays)
    graph.meta.save(directory)


@pytest.fixture(params=[1, 2], ids=["1shard", "2shards"])
def graphs(request, tmp_path):
    """The graph dir written by the port, loaded by both packages."""
    g = random_graph(
        num_nodes=NODES, out_degree=DEGREE, feat_dim=FEAT,
        num_partitions=request.param, seed=4,
    )
    _write(g, str(tmp_path))
    return JaxGraph.load(str(tmp_path), native=False), Graph.load(str(tmp_path), native=False)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("parts", [1, 2])
def test_random_graph_is_bit_identical(parts):
    want = jax_random_graph(
        num_nodes=NODES, out_degree=DEGREE, feat_dim=FEAT,
        num_partitions=parts, seed=9, weighted=True,
    )
    got = random_graph(
        num_nodes=NODES, out_degree=DEGREE, feat_dim=FEAT,
        num_partitions=parts, seed=9, weighted=True,
    )
    assert got.meta.to_dict() == want.meta.to_dict()
    for ws, gs in zip(want.shards, got.shards):
        assert sorted(ws.arrays) == sorted(gs.arrays)
        for k in ws.arrays:
            np.testing.assert_array_equal(gs.arrays[k], ws.arrays[k], err_msg=k)
            assert gs.arrays[k].dtype == ws.arrays[k].dtype


def test_meta_load(graphs, tmp_path):
    jg, pg = graphs
    assert port_meta.load(str(tmp_path)).to_dict() == jg.meta.to_dict()
    assert pg.num_shards == jg.num_shards


def test_sample_node_and_neighbor(graphs):
    jg, pg = graphs
    _assert_same(
        [jg.sample_node(50, rng=np.random.default_rng(7))],
        [pg.sample_node(50, rng=np.random.default_rng(7))],
    )
    ids = np.concatenate(
        [np.arange(1, 40, dtype=np.uint64), [DEFAULT_ID, np.uint64(10**9)]]
    )
    _assert_same(
        jg.sample_neighbor(ids, count=4, rng=np.random.default_rng(8)),
        pg.sample_neighbor(ids, count=4, rng=np.random.default_rng(8)),
    )


def test_dense_features_and_rows(graphs):
    jg, pg = graphs
    ids = np.asarray([3, 1, 2, 299, 300, 10**9], np.uint64)
    _assert_same(
        [jg.get_dense_feature(ids, ["feat", "label"]), jg.lookup_rows(ids)],
        [pg.get_dense_feature(ids, ["feat", "label"]), pg.lookup_rows(ids)],
    )
    rows = pg.lookup_rows(ids)
    _assert_same(
        [jg.get_dense_by_rows(rows, ["feat"])], [pg.get_dense_by_rows(rows, ["feat"])]
    )


def test_full_neighbor_degrees_and_feature_table(graphs):
    """What the device flows stage: padded full adjacency (natural width
    and capped), degrees, and the whole dense feature table."""
    jg, pg = graphs
    ids = np.concatenate(
        [np.arange(1, 40, dtype=np.uint64), [DEFAULT_ID, np.uint64(10**9)]]
    )
    _assert_same(jg.get_full_neighbor(ids), pg.get_full_neighbor(ids))
    _assert_same(
        jg.get_full_neighbor(ids, max_degree=3), pg.get_full_neighbor(ids, max_degree=3)
    )
    _assert_same(
        [jg.degree_sum(ids), jg.dense_feature_table(["feat", "label"])],
        [pg.degree_sum(ids), pg.dense_feature_table(["feat", "label"])],
    )


def _assert_same_batch(jb, pb):
    _assert_same(jb.feats, pb.feats)
    _assert_same(jb.masks, pb.masks)
    _assert_same(jb.hop_ids, pb.hop_ids)
    _assert_same([jb.root_idx, jb.labels], [pb.root_idx, pb.labels])
    assert len(jb.blocks) == len(pb.blocks)
    for jk, pk in zip(jb.blocks, pb.blocks):
        _assert_same(
            [jk.edge_src, jk.edge_dst, jk.edge_w, jk.mask],
            [pk.edge_src, pk.edge_dst, pk.edge_w, pk.mask],
        )
        assert (jk.n_src, jk.n_dst, jk.grid) == (pk.n_src, pk.n_dst, pk.grid)


def test_sage_flow_query_and_padded(graphs):
    jg, pg = graphs
    kw = dict(fanouts=[3, 2], label_feature="label")
    jf = JaxSageDataFlow(jg, ["feat"], rng=np.random.default_rng(11), **kw)
    pf = SageDataFlow(pg, ["feat"], rng=np.random.default_rng(11), **kw)
    roots = np.asarray([5, 17, 17, 250, 10**9], np.uint64)
    _assert_same_batch(jf.query(roots), pf.query(roots))
    (jb, jn), (pb, pn) = jf.query_padded(roots[:3], 8), pf.query_padded(roots[:3], 8)
    assert jn == pn == 3
    _assert_same_batch(jb, pb)
    with pytest.raises(ValueError):
        pf.query_padded(roots, 4)


def test_to_device_keeps_values(graphs):
    _, pg = graphs
    pf = SageDataFlow(pg, ["feat"], fanouts=[3, 2], rng=np.random.default_rng(2))
    hb = pf.query(np.asarray([1, 2, 3], np.uint64))
    tb = to_device(hb, "cpu")
    for h, t in zip(hb.feats + hb.masks, tb.feats + tb.masks):
        np.testing.assert_array_equal(t.numpy(), h)
    blk = tb.blocks[1]
    assert blk.edge_src.dtype == torch.int32 and blk.mask.dtype == torch.bool
    assert blk.edge_w.dtype == torch.float32 and blk.grid == 2
    assert tb.root_idx.dtype == torch.int32 and tb.labels is None


def test_sage_flow_per_hop_path_on_one_store(graphs):
    """A bare shard has no fused fanout: both flows take the per-hop
    sample_neighbor path and still agree bit for bit."""
    jg, pg = graphs
    kw = dict(fanouts=[2, 3], label_feature="label")
    jf = JaxSageDataFlow(jg.shards[0], ["feat"], rng=np.random.default_rng(12), **kw)
    pf = SageDataFlow(pg.shards[0], ["feat"], rng=np.random.default_rng(12), **kw)
    assert not hasattr(pg.shards[0], "fanout_with_rows")
    roots = np.asarray([2, 4, 6, 8], np.uint64)
    _assert_same_batch(jf.query(roots), pf.query(roots))
