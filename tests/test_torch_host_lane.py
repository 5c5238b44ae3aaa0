"""euler_tpu_torch host-batch training lane against the JAX package: the
products-like quality graph and FullNeighborDataFlow (bitwise), the host
batch functions, the Estimator's host lane (losses, evaluate, infer and
the init draw), steps_per_call > 1 over `stack_batches` against K = 1
and JAX's `_train_scan`, optax's adagrad, the Prefetcher, and infer
against the serving runtime.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu import ops as jax_ops
from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageFlow
from euler_tpu.datasets.quality import products_like_graph as jax_products_like
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.estimator import id_batches as jax_id_batches
from euler_tpu.estimator import node_batches as jax_node_batches
from euler_tpu.estimator import read_sample_ids as jax_read_sample_ids
from euler_tpu.estimator import sample_file_batches as jax_sample_file_batches
from euler_tpu.estimator.estimator import stack_batches as jax_stack_batches
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.training import ResumableSource as JaxResumableSource
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import FullNeighborDataFlow, SageDataFlow
from euler_tpu_torch.datasets import graph_with_degrees, products_like_graph, random_graph
from euler_tpu_torch.estimator import (
    Estimator,
    EstimatorConfig,
    OptaxAdagrad,
    Prefetcher,
    id_batches,
    node_batches,
    read_sample_ids,
    sample_file_batches,
    stack_batches,
)
from euler_tpu_torch.graph import DEFAULT_ID, Graph, write_arrays
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import from_flax
from euler_tpu_torch.serving import InferenceRuntime
from euler_tpu_torch.training import CheckpointStore, ResumableSource, TrainingSession

torch.set_num_threads(1)

FEAT, DIMS, LABEL_DIM, FANOUTS, BATCH = 8, [8, 8], 2, [4, 3], 12
CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)


def _write(graph, directory):
    for p, shard in enumerate(graph.shards):
        write_arrays(os.path.join(directory, f"part_{p}"), shard.arrays)
    graph.meta.save(directory)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """One 240-node graph dir written by the port, loaded by both."""
    d = str(tmp_path_factory.mktemp("graph"))
    _write(random_graph(num_nodes=240, out_degree=5, feat_dim=FEAT, seed=6), d)
    return JaxGraph.load(d, native=False), Graph.load(d, native=False)


def _flax_tree(seed=0):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.normal(0, i**-0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    return {"params": {
        "net": {"gnn": {"convs_0": {"Dense_0": dense(2 * FEAT, DIMS[0])},
                        "convs_1": {"Dense_0": dense(2 * DIMS[0], DIMS[1])}}},
        "out": dense(DIMS[1], LABEL_DIM),
    }}


def _assert_batches_equal(jb, pb):
    """Every field of two MiniBatches bitwise, hop_ids included."""
    for name in ("feats", "masks", "hop_ids"):
        a, b = getattr(jb, name), getattr(pb, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            x = np.asarray(x)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(y, x, err_msg=name)
    for name in ("root_idx", "labels"):
        x, y = np.asarray(getattr(jb, name)), getattr(pb, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x, err_msg=name)
    for a, b in zip(jb.blocks, pb.blocks):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        for name in ("edge_src", "edge_dst", "edge_w", "mask"):
            x, y = np.asarray(getattr(a, name)), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(y, x, err_msg=name)


@pytest.mark.parametrize("parts", [1, 2])
def test_products_like_graph_matches_jax(parts):
    kw = dict(num_nodes=2000, num_classes=7, seed=5, num_partitions=parts)
    jg, jtypes = jax_products_like(**kw)
    pg, ptypes = products_like_graph(**kw)
    np.testing.assert_array_equal(ptypes, jtypes)
    assert ptypes.dtype == jtypes.dtype
    assert pg.meta.to_dict() == jg.meta.to_dict()
    for ws, gs in zip(jg.shards, pg.shards):
        assert sorted(ws.arrays) == sorted(gs.arrays)
        for k in ws.arrays:
            assert gs.arrays[k].dtype == ws.arrays[k].dtype, k
            np.testing.assert_array_equal(gs.arrays[k], ws.arrays[k], err_msg=k)
        assert gs.graph_epoch == ws.graph_epoch == 0


def test_full_neighbor_query_matches_jax(tmp_path):
    # degree 0, degrees past max_degree (4) and in between
    deg = [0, 3, 12, 1, 0, 7, 4, 5, 2, 9, 0, 6]
    _write(graph_with_degrees(deg, seed=2), str(tmp_path))
    jg, pg = JaxGraph.load(str(tmp_path), native=False), Graph.load(str(tmp_path), native=False)
    kw = dict(num_hops=2, max_degree=4, label_feature="label")
    jflow, pflow = JaxFullFlow(jg, ["feat"], **kw), FullNeighborDataFlow(pg, ["feat"], **kw)
    roots = np.array([1, 3, 5, 11, 2, 12, 10], np.uint64)
    roots = np.concatenate([roots, [DEFAULT_ID, np.uint64(10**6)]])
    jb, pb = jflow.query(roots), pflow.query(roots)
    assert pb.blocks[1].n_src == len(roots) * 16
    _assert_batches_equal(jb, pb)
    with pytest.raises(NotImplementedError, match="gcn_norm"):
        FullNeighborDataFlow(pg, ["feat"], gcn_norm=True)


def test_node_batches_and_id_batches_match_jax(graphs):
    jg, pg = graphs
    jflow = JaxSageFlow(jg, ["feat"], fanouts=FANOUTS, label_feature="label",
                        rng=np.random.default_rng(1))
    pflow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, label_feature="label",
                         rng=np.random.default_rng(1))
    jfn = jax_node_batches(jg, jflow, BATCH, rng=np.random.default_rng(2))
    pfn = node_batches(pg, pflow, BATCH, rng=np.random.default_rng(2))
    for _ in range(3):
        (jb,), (pb,) = jfn(), pfn()
        _assert_batches_equal(jb, pb)
    ids = np.arange(3, 30, dtype=np.uint64)  # 27 ids: the last chunk pads
    jbs, jids = jax_id_batches(jflow, ids, 10)
    pbs, pids = id_batches(pflow, ids, 10)
    for (jb,), (pb,), a, b in zip(jbs, pbs, jids, pids, strict=True):
        np.testing.assert_array_equal(b, a)
        _assert_batches_equal(jb, pb)
    assert len(b) == 7 and len(pb.root_idx) == 10 and pb.root_idx[-1] == 29


def test_sample_file_batches_match_jax(graphs, tmp_path):
    jg, pg = graphs
    path = str(tmp_path / "samples.csv")
    with open(path, "w") as f:
        f.write("".join(f"x{i},{i * 7 % 240 + 1},y\n" for i in range(13)) + "\n")
    np.testing.assert_array_equal(read_sample_ids(path, 1), jax_read_sample_ids(path, 1))
    kw = dict(num_hops=2, max_degree=3, label_feature="label")
    jflow, pflow = JaxFullFlow(jg, ["feat"], **kw), FullNeighborDataFlow(pg, ["feat"], **kw)
    got = list(sample_file_batches(pflow, path, 5, epochs=2, column=1))
    want = list(jax_sample_file_batches(jflow, path, 5, epochs=2, column=1))
    assert len(got) == len(want) == 6
    for (jb,), (pb,) in zip(want, got):
        _assert_batches_equal(jb, pb)


def _host_pair(graphs, optimizer, steps, tmp, jax_mode, batch=BATCH, fanouts=FANOUTS):
    """A JAX and a port Estimator over the same host batches (node_batches
    from the same seeds), the port's conv on the fused path's plain
    version (kernel mode 'ref'), the JAX conv in pallas mode `jax_mode`."""
    jg, pg = graphs
    fkw = dict(fanouts=fanouts, label_feature="label")
    jfn = jax_node_batches(jg, JaxSageFlow(jg, ["feat"], rng=np.random.default_rng(4), **fkw),
                           batch, rng=np.random.default_rng(5))
    pfn = node_batches(pg, SageDataFlow(pg, ["feat"], rng=np.random.default_rng(4), **fkw),
                       batch, rng=np.random.default_rng(5))
    tree = _flax_tree(seed=2)
    jest = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM), jfn,
                        JaxConfig(model_dir=f"{tmp}/jax", optimizer=optimizer, **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    pest = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), pfn,
                     EstimatorConfig(model_dir=f"{tmp}/port", optimizer=optimizer, **CFG),
                     init_params=from_flax(tree), device="cpu")
    prev = jax_ops.pallas_mode()
    jax_ops.set_pallas(jax_mode)
    ops.set_kernel_mode("ref")
    try:
        jl = jest.train(steps, log=False, save=False)
        pl = pest.train(steps, log=False, save=False)
    finally:
        jax_ops.set_pallas(prev)
        ops.set_kernel_mode("auto")
    return jest, pest, np.asarray(jl), np.asarray(pl)


@pytest.fixture(scope="module")
def sgd_pair(graphs, tmp_path_factory):
    # the JAX conv as the JAX tests run Pallas on the CPU: interpreted,
    # whose tracing grows with the batch (4 roots, fanouts 2,2: ~5 s)
    return _host_pair(graphs, "sgd", 5, str(tmp_path_factory.mktemp("sgd")), "interpret",
                      batch=4, fanouts=[2, 2])


def test_host_lane_sgd_losses_match_jax(sgd_pair):
    _, pest, jl, pl = sgd_pair
    assert len(pl) == 5 and np.isfinite(pl).all() and pest.last_losses == pl.tolist()
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def test_host_lane_adam_losses_match_jax(graphs, tmp_path):
    # the JAX conv on its segment-op path, as test_torch_train's adam
    # trajectory runs it (the interpreted kernel costs ~7 s of tracing)
    _, _, jl, pl = _host_pair(graphs, "adam", 3, str(tmp_path), "off")
    np.testing.assert_allclose(pl, jl, rtol=1e-3, atol=1e-3)


def _eval_batches(flow, lo, hi, size):
    return [(flow.query(np.arange(lo + i, lo + i + size, dtype=np.uint64)),)
            for i in range(0, hi - lo, size)]


def test_host_lane_evaluate_matches_jax(graphs, sgd_pair):
    jg, pg = graphs
    jest, pest, _, _ = sgd_pair
    kw = dict(num_hops=2, max_degree=4, label_feature="label")
    jflow, pflow = JaxFullFlow(jg, ["feat"], **kw), FullNeighborDataFlow(pg, ["feat"], **kw)
    want = jest.evaluate(_eval_batches(jflow, 1, 61, 20))
    got = pest.evaluate(_eval_batches(pflow, 1, 61, 20))
    assert sorted(got) == sorted(want) == ["f1", "loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_host_lane_infer_matches_jax(graphs, sgd_pair):
    jg, pg = graphs
    jest, pest, _, _ = sgd_pair
    kw = dict(num_hops=2, max_degree=4)
    ids = np.arange(5, 38, dtype=np.uint64)  # 33 ids: the last chunk pads
    jids, jemb = jest.infer(*jax_id_batches(JaxFullFlow(jg, ["feat"], **kw), ids, 16), worker=1)
    pids, pemb = pest.infer(*id_batches(FullNeighborDataFlow(pg, ["feat"], **kw), ids, 16),
                            worker=1)
    np.testing.assert_array_equal(pids, jids)
    assert pemb.shape == (33, DIMS[-1])
    np.testing.assert_allclose(pemb, jemb, rtol=1e-4, atol=1e-4)
    for name in ("embedding_1.npy", "ids_1.npy"):
        a = np.load(os.path.join(pest.cfg.model_dir, name))
        b = np.load(os.path.join(jest.cfg.model_dir, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name


def test_init_draw_leaves_the_cursor_of_jax(graphs, tmp_path):
    """Without init_params, JAX initialises from one batch_fn() draw; the
    port consumes the same draw, so a ResumableSource's cursor agrees."""
    jg, pg = graphs
    kw = dict(num_hops=2, max_degree=3, label_feature="label")
    jflow, pflow = JaxFullFlow(jg, ["feat"], **kw), FullNeighborDataFlow(pg, ["feat"], **kw)
    jsrc = JaxResumableSource(lambda r: (jflow.query(jg.sample_node(8, rng=r)),), seed=1)
    psrc = ResumableSource(lambda r: (pflow.query(pg.sample_node(8, rng=r)),), seed=1)
    jest = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM), jsrc,
                        JaxConfig(model_dir=str(tmp_path / "j"), **CFG))
    pest = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), psrc,
                     EstimatorConfig(model_dir=str(tmp_path / "p"), **CFG), device="cpu")
    jest.train(2, log=False, save=False)
    pest.train(2, log=False, save=False)
    assert psrc.cursor() == jsrc.cursor() == 3
    pest.train(1, log=False, save=False)
    pest.evaluate([psrc()])
    assert psrc.cursor() == 5  # the draw is taken once


def test_adagrad_trajectory_matches_optax():
    """200 adagrad steps against optax's, both in f64 so the comparison
    sees the update's formula and not f32 rounding. optax scales by
    rsqrt(s + eps), where torch's Adagrad divides by sqrt(s) + eps: a gap
    of ~1.8e-7 relative a step while s stays near its initial 0.1, which
    small gradients of one sign under a large learning rate accumulate to
    ~1e-5 over the run (torch's Adagrad fails this test)."""
    rng = np.random.default_rng(12)
    w0 = rng.normal(size=(6, 5))
    sign = rng.choice([-1.0, 1.0], size=(6, 5))
    grads = [0.01 * rng.uniform(0.5, 1.5, size=(6, 5)) * sign for _ in range(200)]
    with jax.enable_x64(True):
        tx = optax.adagrad(10.0)
        p = jnp.asarray(w0)
        state = tx.init(p)
        update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
            *tx.update(g, s, p)))
        want = []
        for g in grads:
            p, state = update(jnp.asarray(g), state, p)
            want.append(np.asarray(p))
        want_sum = np.asarray(jax.tree_util.tree_leaves(state)[0])
    t = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = OptaxAdagrad([t], lr=10.0)
    for g, w in zip(grads, want):
        t.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(opt.state[t]["sum"].numpy(), want_sum, rtol=0, atol=1e-6)
    assert np.abs(want[-1] - w0).max() > 50  # far enough to show the gap


def _pipeline(graphs, tmp, batch_fn, name):
    _, pg = graphs
    return Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), batch_fn,
                     EstimatorConfig(model_dir=f"{tmp}/{name}", optimizer="adam", **CFG),
                     device="cpu")


def test_prefetcher_one_worker_gives_the_same_losses(graphs, tmp_path):
    _, pg = graphs

    def source():
        flow = SageDataFlow(pg, ["feat"], fanouts=FANOUTS, label_feature="label",
                            rng=np.random.default_rng(8))
        return node_batches(pg, flow, BATCH, rng=np.random.default_rng(9))

    plain = _pipeline(graphs, tmp_path, source(), "plain").train(6, log=False, save=False)
    pre = Prefetcher(source(), depth=3, workers=1, device_put=True, device="cpu")
    try:
        got = _pipeline(graphs, tmp_path, pre, "pre").train(6, log=False, save=False)
        (staged,) = pre()
    finally:
        pre.close()
    assert isinstance(staged.feats[0], torch.Tensor) and staged.hop_ids is not None
    assert got == plain


def test_prefetcher_surfaces_producer_errors():
    def fn():
        raise OSError("shard gone")

    pre = Prefetcher(fn, workers=2)
    try:
        with pytest.raises(OSError, match="shard gone"):
            pre()
    finally:
        pre.close()
    assert not any(t.is_alive() for t in pre._threads)


def test_infer_matches_inference_runtime(graphs, sgd_pair):
    """`Estimator.infer` and `InferenceRuntime.predict` over the same
    checkpoint and FullNeighborDataFlow: the same embeddings, bitwise."""
    _, pg = graphs
    _, pest, _, _ = sgd_pair
    pest.save()
    flow = FullNeighborDataFlow(pg, ["feat"], num_hops=2, max_degree=4)
    ids = np.arange(1, 41, dtype=np.uint64)
    _, emb = pest.infer(*id_batches(flow, ids, 16))
    rt = InferenceRuntime(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), flow,
                          cfg=pest.cfg, buckets=(16,), device="cpu")
    np.testing.assert_array_equal(rt.predict(ids), emb)


def test_train_crash_surfaces_losses_and_checkpoint(graphs, tmp_path):
    _, pg = graphs
    flow = FullNeighborDataFlow(pg, ["feat"], num_hops=2, max_degree=3, label_feature="label")
    calls = [0]

    def bf():
        # the init draw is call 0; step k is call k
        if calls[0] == 5:
            raise RuntimeError("shard died mid-epoch")
        calls[0] += 1
        return (flow.query(pg.sample_node(8, rng=np.random.default_rng(calls[0]))),)

    est = _pipeline(graphs, tmp_path, bf, "crash")
    with pytest.raises(RuntimeError, match="shard died"):
        est.train(10)
    assert len(est.last_losses) == 4 and np.isfinite(est.last_losses).all()
    assert CheckpointStore(est.cfg.model_dir).latest_step() == 4


def test_profile_writes_one_trace(graphs, tmp_path):
    _, pg = graphs
    flow = FullNeighborDataFlow(pg, ["feat"], num_hops=2, max_degree=3, label_feature="label")
    src = ResumableSource(lambda r: (flow.query(pg.sample_node(8, rng=r)),))
    est = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), src,
                    EstimatorConfig(model_dir=str(tmp_path / "m"), log_steps=10**9,
                                    profile_dir=str(tmp_path / "prof"), profile_start_step=1,
                                    profile_steps=2), device="cpu")
    est.train(2, log=False, save=False)
    est.train(3, log=False, save=False)
    assert os.listdir(tmp_path / "prof") == ["trace_step1.json"]
    # grouped steps train (the tests below); a TrainingSession still
    # refuses them, as the JAX package's does
    grouped = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), src,
                        EstimatorConfig(steps_per_call=2), device="cpu")
    with pytest.raises(ValueError, match="steps_per_call=1"):
        TrainingSession(grouped, source=src)


def test_stack_batches_matches_jax(graphs):
    """K host batches stacked on a leading axis, bitwise as JAX's
    `stack_batches` stacks them (hop_ids too); a window whose batches
    differ in structure raises JAX's ValueError in both packages."""
    jg, pg = graphs
    kw = dict(fanouts=FANOUTS, label_feature="label")

    def sources(fanouts):
        jflow = JaxSageFlow(jg, ["feat"], rng=np.random.default_rng(1), **{**kw, "fanouts": fanouts})
        pflow = SageDataFlow(pg, ["feat"], rng=np.random.default_rng(1), **{**kw, "fanouts": fanouts})
        return (jax_node_batches(jg, jflow, BATCH, rng=np.random.default_rng(2)),
                node_batches(pg, pflow, BATCH, rng=np.random.default_rng(2)))

    jfn, pfn = sources(FANOUTS)
    (jb,), (pb,) = jax_stack_batches(jfn, 3)(), stack_batches(pfn, 3)()
    assert pb.feats[2].shape == (3, BATCH * 12, FEAT) and pb.blocks[1].n_src == BATCH * 12
    _assert_batches_equal(jb, pb)
    (j1, p1), (j2, p2) = sources(FANOUTS), sources(FANOUTS[:1])
    mixed = {"jax": iter([j1(), j2(), j1()]), "port": iter([p1(), p2(), p1()])}
    for name, stack in (("jax", jax_stack_batches), ("port", stack_batches)):
        with pytest.raises(ValueError, match="identical pytree structure"):
            stack(lambda it=mixed[name]: next(it), 3)()


# steps_per_call: 27 steps at K = 8 are 3 calls and a remainder of 3,
# which takes the first 3 slices of one more stacked item
GROUP_K, GROUP_STEPS = 8, 27
GROUP_TOL = {"sgd": 1e-5, "adam": 1e-3}  # as the K = 1 trajectories above


@pytest.fixture(scope="module", params=["sgd", "adam"])
def grouped_host(request, graphs, tmp_path_factory):
    """27 steps of the port at K = 1 and K = 8 and of JAX's `_train_scan`
    at K = 8, from the same init over a ResumableSource each (stacked by
    `stack_batches` at K = 8), with a checkpoint every 10 steps on the
    port; the port's conv in mode 'ref', JAX's in pallas mode 'off'."""
    jg, pg = graphs
    optimizer, tmp = request.param, str(tmp_path_factory.mktemp(request.param))
    tree = _flax_tree(seed=2)
    kw = dict(num_hops=2, max_degree=3, label_feature="label")
    out = {"optimizer": optimizer, "tmp": tmp}
    ops.set_kernel_mode("ref")
    try:
        for k in (1, GROUP_K):
            flow = FullNeighborDataFlow(pg, ["feat"], **kw)
            src = ResumableSource(lambda r, flow=flow: (flow.query(pg.sample_node(8, rng=r)),),
                                  seed=1)
            est = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM),
                            src if k == 1 else stack_batches(src, k),
                            EstimatorConfig(model_dir=f"{tmp}/port{k}", optimizer=optimizer,
                                            steps_per_call=k, checkpoint_steps=10, **CFG),
                            init_params=from_flax(tree), device="cpu")
            out[k] = {"losses": est.train(GROUP_STEPS, log=False), "est": est,
                      "cursor": src.cursor()}
    finally:
        ops.set_kernel_mode("auto")
    jflow = JaxFullFlow(jg, ["feat"], **kw)
    jsrc = JaxResumableSource(lambda r: (jflow.query(jg.sample_node(8, rng=r)),), seed=1)
    jest = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM), jax_stack_batches(jsrc, GROUP_K),
                        JaxConfig(model_dir=f"{tmp}/jax", optimizer=optimizer,
                                  steps_per_call=GROUP_K, **CFG),
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    prev = jax_ops.pallas_mode()
    jax_ops.set_pallas("off")
    try:
        out["jax"] = {"losses": jest.train(GROUP_STEPS, log=False, save=False),
                      "cursor": jsrc.cursor()}
    finally:
        jax_ops.set_pallas(prev)
    return out


def test_grouped_host_steps_equal_single_steps(grouped_host):
    """K = 8 against K = 1 over the same host batches: losses and final
    params bitwise. The source cursor shows the remainder rule: K = 8
    takes four stacked items (32 draws) for 27 steps; checkpoints fall in
    the calls that cross the cadence (16, 24) and at the end."""
    one, grouped = grouped_host[1], grouped_host[GROUP_K]
    assert len(grouped["losses"]) == GROUP_STEPS and np.isfinite(grouped["losses"]).all()
    assert grouped["losses"] == one["losses"]
    assert grouped["est"].last_losses == grouped["losses"]
    assert grouped["est"].step == one["est"].step == GROUP_STEPS
    for (name, a), b in zip(one["est"].model.state_dict().items(),
                            grouped["est"].model.state_dict().values()):
        assert torch.equal(a, b), name
    assert (one["cursor"], grouped["cursor"]) == (GROUP_STEPS, 4 * GROUP_K)
    store = CheckpointStore(grouped["est"].cfg.model_dir, keep=5)
    assert store.steps() == [16, 24, GROUP_STEPS]


def test_grouped_host_steps_match_jax_train_scan(grouped_host):
    """The port at K = 8 against JAX's `_train_scan` at K = 8: the losses
    within the K = 1 tolerances, and the same number of batch_fn draws."""
    tol = GROUP_TOL[grouped_host["optimizer"]]
    got, want = grouped_host[GROUP_K], grouped_host["jax"]
    assert len(want["losses"]) == GROUP_STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=tol, atol=tol)
    assert got["cursor"] == want["cursor"] == 4 * GROUP_K
