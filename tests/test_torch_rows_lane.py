"""euler_tpu_torch's rows-mode host lane against the JAX package, on
graphs both load through the native engine: `SageDataFlow(feature_mode=
"rows", lean=True)` batches bit for bit (unit weights, the weighted-lean
wire's bf16 weights, and a dangling row that forces the sticky
downgrade), `upgrade_lean_host`, `stack_batches` over a window that mixes
lean and downgraded batches, `FullNeighborDataFlow(feature_mode="rows")`,
and the host-lane Estimator over a `DeviceFeatureCache` on lean batches
(losses within 1e-5 of JAX's at steps_per_call 1 and 2); on the port
alone, a lean batch hydrated against its upgrade and the non-lean batch,
and its None leaves through a Prefetcher and the step signature.

The JAX binding is pointed at the port's engine build, so no test builds
or loads the JAX binding's own library file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
from euler_tpu import ops as jax_ops
from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageFlow
from euler_tpu.dataflow.base import upgrade_lean_host as jax_upgrade_lean_host
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.estimator.estimator import stack_batches as jax_stack_batches
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import (
    FullNeighborDataFlow,
    SageDataFlow,
    hydrate_blocks,
    to_device,
    upgrade_lean_host,
)
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import (
    DeviceFeatureCache,
    Estimator,
    EstimatorConfig,
    Prefetcher,
    stack_batches,
)
from euler_tpu_torch.estimator.graph_step import signature
from euler_tpu_torch.graph import Graph, write_arrays
from euler_tpu_torch.graph import native
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import from_flax
from test_torch_host_lane import CFG, DIMS, FEAT, LABEL_DIM, _flax_tree

torch.set_num_threads(1)

FANOUTS, BATCH = [4, 3], 12
MISSING = np.uint64(10**6)  # an id no graph here holds


@pytest.fixture(scope="module")
def engine():
    path = native.build_engine()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "build_engine", lambda force=False: path)
    mp.setattr(jax_native, "_lib", None)
    yield path
    mp.undo()


def _write(graph, directory, dangling=None):
    """Write the graph; `dangling`: a node whose out-edges all lead to an
    id the graph lacks, and which no edge leads to."""
    for p, shard in enumerate(graph.shards):
        arrays = dict(shard.arrays)
        if dangling is not None:
            dst = np.where(arrays["adj_0_dst"] == dangling, np.uint64(1), arrays["adj_0_dst"])
            row = int(np.searchsorted(arrays["node_ids"], dangling))
            lo, hi = arrays["adj_0_indptr"][row : row + 2]
            dst[lo:hi] = MISSING
            arrays["adj_0_dst"] = arrays["edge_dst"] = dst
        write_arrays(os.path.join(directory, f"part_{p}"), arrays)
    graph.meta.save(directory)


@pytest.fixture(scope="module")
def dirs(engine, tmp_path_factory):
    out = {}
    for name, kw in (("unit", {}), ("weighted", {"weighted": True}),
                     ("2shards", {"num_partitions": 2}), ("dangling", {}),
                     ("dangling_weighted", {"weighted": True})):
        d = str(tmp_path_factory.mktemp(name))
        _write(random_graph(num_nodes=240, out_degree=5, feat_dim=FEAT, seed=6, **kw), d,
               dangling=np.uint64(240) if name.startswith("dangling") else None)
        out[name] = d
    return out


def _graphs(dirs, name):
    return JaxGraph.load(dirs[name], native=True), Graph.load(dirs[name], native=True)


def _flows(jg, pg, seed=1, **kw):
    kw = {"fanouts": FANOUTS, "label_feature": "label", "feature_mode": "rows", "lean": True,
          **kw}
    return (JaxSageFlow(jg, ["feat"], rng=np.random.default_rng(seed), **kw),
            SageDataFlow(pg, ["feat"], rng=np.random.default_rng(seed), **kw))


def _bits(x):
    """An array's dtype and bits; a bfloat16 leaf (ml_dtypes on JAX's
    side, a torch tensor on the port's) as its uint16 words."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return "bfloat16", x.view(torch.int16).numpy().view(np.uint16)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return "bfloat16", x.view(np.uint16)
    return x.dtype.name, x


def _assert_batches_equal(jb, pb):
    """Every leaf of two MiniBatches: None where the other is None, else
    dtype, shape and bits; the static block fields equal."""
    def same(x, y, what):
        assert (x is None) == (y is None), what
        if x is None:
            return
        (dx, ax), (dy, ay) = _bits(x), _bits(y)
        assert dx == dy and ax.shape == ay.shape, what
        np.testing.assert_array_equal(ay, ax, err_msg=what)

    for name in ("feats", "masks", "hop_ids"):
        a, b = getattr(jb, name), getattr(pb, name)
        assert (a is None) == (b is None), name
        for i, (x, y) in enumerate(zip(a or (), b or (), strict=True)):
            same(x, y, f"{name}[{i}]")
    for name in ("root_idx", "labels"):
        same(getattr(jb, name), getattr(pb, name), name)
    for i, (a, b) in enumerate(zip(jb.blocks, pb.blocks, strict=True)):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        for name in ("edge_src", "edge_dst", "edge_w", "mask"):
            same(getattr(a, name), getattr(b, name), f"blocks[{i}].{name}")


@pytest.mark.parametrize("name", ["unit", "weighted", "2shards"])
def test_lean_rows_batches_match_jax(dirs, name):
    jg, pg = _graphs(dirs, name)
    jflow, pflow = _flows(jg, pg)
    assert pflow._lean_w == jflow._lean_w == (name == "weighted")
    for _ in range(3):
        jb, pb = jflow.minibatch(BATCH), pflow.minibatch(BATCH)
        _assert_batches_equal(jb, pb)
        assert pb.masks is None and pb.hop_ids is None and pb.blocks[0].edge_src is None
        assert (pb.blocks[0].edge_w is None) == (name != "weighted")
        _assert_batches_equal(jax_upgrade_lean_host(jb), upgrade_lean_host(pb))
    assert not pflow._lean_off and not jflow._lean_off
    # not lean: rows mode with every array shipped, hop_ids included
    jflow, pflow = _flows(jg, pg, seed=2, lean=False)
    roots = pg.sample_node(BATCH, rng=np.random.default_rng(4))
    _assert_batches_equal(jflow.query(roots), pflow.query(roots))
    assert pflow.query(roots).hop_ids is not None
    with pytest.raises(ValueError, match="lean=True requires"):
        SageDataFlow(pg, ["feat"], lean=True)


def _roots(seed, with_dangling=False):
    """BATCH roots of the dangling graph: node 240 only when asked."""
    roots = np.random.default_rng(seed).integers(1, 240, BATCH).astype(np.uint64)
    if with_dangling:
        roots[3] = 240
    return roots


@pytest.mark.parametrize("name", ["dangling", "dangling_weighted"])
def test_dangling_row_downgrades_for_good(dirs, name):
    jg, pg = _graphs(dirs, name)
    jflow, pflow = _flows(jg, pg)
    for i, dangling in enumerate((False, True, False)):
        roots = _roots(i, dangling)
        jb, pb = jflow.query(roots), pflow.query(roots)
        _assert_batches_equal(jb, pb)
        assert (pb.masks is None) == (i == 0) and pb.hop_ids is None
        assert pflow._lean_off == jflow._lean_off == (i > 0)


@pytest.mark.parametrize("name,dangling_at", [("dangling", 2), ("dangling_weighted", 2),
                                               ("dangling_weighted", None)])
def test_stack_batches_upgrades_a_mixed_window(dirs, name, dangling_at):
    """A window of 4 from a dangling graph: two lean batches, then the
    downgrade; the lean ones (bf16 weights on the weighted graph) are
    upgraded on the host and the window stacks, bitwise as JAX's. A
    window without the dangling root stays lean (bf16 weights stacked)."""
    jg, pg = _graphs(dirs, name)
    jflow, pflow = _flows(jg, pg)
    plan = [_roots(i, i == dangling_at) for i in range(4)]

    def source(flow):
        it = iter(plan)
        return lambda: (flow.query(next(it)),)

    (jb,), (pb,) = jax_stack_batches(source(jflow), 4)(), stack_batches(source(pflow), 4)()
    assert (pb.masks is not None) == (dangling_at is not None)
    assert pb.feats[2].shape == (4, BATCH * 12)
    if dangling_at is None:
        assert pb.blocks[1].edge_w.dtype == torch.bfloat16
        assert pb.blocks[1].edge_w.shape == (4, BATCH * 12)
    _assert_batches_equal(jb, pb)


def test_full_neighbor_rows_matches_jax(dirs):
    jg, pg = _graphs(dirs, "2shards")
    kw = dict(num_hops=2, max_degree=4, label_feature="label", feature_mode="rows")
    roots = np.concatenate([np.arange(1, 20, dtype=np.uint64), [MISSING]])
    jb = JaxFullFlow(jg, ["feat"], **kw).query(roots)
    pb = FullNeighborDataFlow(pg, ["feat"], **kw).query(roots)
    assert pb.feats[0].dtype == np.int32 and pb.feats[0][-1] == 0
    _assert_batches_equal(jb, pb)


def test_lean_batch_hydrates_as_its_upgrade(dirs):
    """On the port's device path, a lean batch hydrated equals its host
    upgrade moved, and (rows gathered) the same roots' non-lean batch."""
    _, pg = _graphs(dirs, "weighted")
    _, lean = _flows(pg, pg)
    _, full = _flows(pg, pg, lean=False)
    cache = DeviceFeatureCache(pg, ["feat"], device="cpu")
    roots = pg.sample_node(BATCH, rng=np.random.default_rng(5))
    lb, fb = lean.query(roots), full.query(roots)
    a = cache.hydrate(hydrate_blocks(to_device(lb, "cpu")))
    b = cache.hydrate(hydrate_blocks(to_device(upgrade_lean_host(lb), "cpu")))
    c = cache.hydrate(hydrate_blocks(to_device(fb, "cpu")))
    for other in (b, c):
        for x, y in zip(a.feats + a.masks, other.feats + other.masks, strict=True):
            assert torch.equal(x, y)
        for p, q in zip(a.blocks, other.blocks, strict=True):
            for name in ("edge_src", "edge_dst", "edge_w", "mask"):
                # the weighted-lean wire rounds weights to bf16
                want = getattr(q, name)
                if name == "edge_w" and other is c:
                    want = want.to(torch.bfloat16).float()
                assert torch.equal(getattr(p, name), want), name


def test_lean_leaves_pass_staging_and_signatures(dirs):
    """A lean batch's None leaves stay None through a Prefetcher's
    staging, and its step signature differs from its upgrade's (one
    captured graph each)."""
    _, pg = _graphs(dirs, "weighted")
    _, flow = _flows(pg, pg)
    pre = Prefetcher(lambda: (flow.minibatch(BATCH),), depth=2, workers=1, device_put=True,
                     device="cpu")
    try:
        (staged,) = pre()
    finally:
        pre.close()
    assert staged.masks is None and staged.blocks[0].mask is None
    assert staged.blocks[0].edge_src is None and staged.blocks[0].edge_w.dtype == torch.bfloat16
    assert isinstance(staged.feats[0], torch.Tensor)
    lean = flow.minibatch(BATCH)
    assert signature((to_device(lean, "cpu"),)) != signature(
        (to_device(upgrade_lean_host(lean), "cpu"),))


@pytest.fixture(scope="module")
def lean_losses(dirs, tmp_path_factory):
    """3 sgd steps of the host lane over lean rows batches and a
    DeviceFeatureCache, at steps_per_call 1 and 2, in both packages from
    one flax init; JAX's conv on its segment-op path, the port's in mode
    'ref'."""
    jg, pg = _graphs(dirs, "unit")
    tmp = str(tmp_path_factory.mktemp("lean"))
    tree = _flax_tree(seed=2)
    out = {}
    for k in (1, 2):
        jflow, pflow = _flows(jg, pg)

        def source(flow, graph):
            rng = np.random.default_rng(5)
            return lambda: (flow.query(graph.sample_node(BATCH, rng=rng)),)

        jfn, pfn = source(jflow, jg), source(pflow, pg)
        cfg = dict(optimizer="sgd", steps_per_call=k, **CFG)
        jest = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM),
                            jfn if k == 1 else jax_stack_batches(jfn, k),
                            JaxConfig(model_dir=f"{tmp}/jax{k}", **cfg),
                            feature_cache=JaxFeatureCache(jg, ["feat"]),
                            init_params=jax.tree_util.tree_map(jnp.asarray, tree))
        pest = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM),
                         pfn if k == 1 else stack_batches(pfn, k),
                         EstimatorConfig(model_dir=f"{tmp}/port{k}", **cfg),
                         feature_cache=DeviceFeatureCache(pg, ["feat"], device="cpu"),
                         init_params=from_flax(tree), device="cpu")
        prev = jax_ops.pallas_mode()
        jax_ops.set_pallas("off")
        ops.set_kernel_mode("ref")
        try:
            out[k] = (np.asarray(jest.train(3, log=False, save=False)),
                      np.asarray(pest.train(3, log=False, save=False)))
        finally:
            jax_ops.set_pallas(prev)
            ops.set_kernel_mode("auto")
        assert pflow._lean_off == jflow._lean_off is False
    return out


@pytest.mark.parametrize("k", [1, 2])
def test_host_lane_on_lean_rows_matches_jax(lean_losses, k):
    jl, pl = lean_losses[k]
    assert len(pl) == 3 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    if k == 2:  # the same batches in the same order at both K
        np.testing.assert_array_equal(pl, lean_losses[1][1])
