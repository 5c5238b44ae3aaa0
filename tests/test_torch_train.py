"""euler_tpu_torch training slice against the JAX package: the skewed
graph, batch hydration and the feature cache (bitwise), the
gather_weighted_sum gradients, GraphSAGESupervised's loss, metric and
grads, the optimizers' updates and state leaves, the Estimator's loss
trajectory from the same init and the same draws (steps_per_call 1 and 8
against JAX's step and `_train_scan`), and checkpoints the two packages
read from each other.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.dataflow.base import hydrate_blocks as jax_hydrate_blocks
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.ops.pallas_kernels import gather_weighted_sum as jax_gws
from euler_tpu_torch.dataflow import DeviceSageFlow, SageDataFlow, hydrate_blocks
from euler_tpu_torch.datasets import random_graph, skewed_weighted_graph
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
from euler_tpu_torch.estimator import make_optimizer
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.ops import gather_weighted_sum
from euler_tpu_torch.params import checkpoint_order, from_flax, optimizer_leaves, to_flax_leaf
from euler_tpu_torch.serving import InferenceRuntime

torch.set_num_threads(1)

FEAT, DIMS, LABEL_DIM, FANOUTS, BATCH = 8, [8, 8], 2, [4, 3], 12
CFG = dict(learning_rate=0.05, log_steps=10**9, seed=3)


def _draws(jflow, key):
    """The random numbers JAX's DeviceSageFlow.sample(key) draws
    (device.py:1070-1075, :1033), as the port's draw_inputs returns them."""
    kroot, khops = jax.random.split(key)
    roots = torch.from_numpy(np.array(jflow._draw_roots(kroot, jflow.batch_size)))
    draws, width = [], jflow.batch_size
    for k, hk in zip(jflow.fanouts, jax.random.split(khops, len(jflow.fanouts))):
        if jflow.unit_w:
            d = np.array(jax.random.uniform(hk, (width, k)))
        else:
            d = np.array(jax.random.bits(hk, (width, k), dtype=jnp.uint32)).view(np.int32)
        draws.append(torch.from_numpy(d))
        width *= k
    return roots, tuple(draws)


@pytest.fixture(scope="module")
def setup():
    """One weighted graph in both packages, paged flows (P = 8) and f32
    feature caches on each side."""
    kw = dict(num_nodes=300, out_degree=6, feat_dim=FEAT, seed=4, weighted=True)
    jg, pg = jax_random_graph(**kw), random_graph(**kw)
    fkw = dict(fanouts=FANOUTS, batch_size=BATCH, label_feature="label", layout="paged",
               page_size=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EULER_TPU_PAGE_DTYPE", "f32")
        yield {
            "jg": jg, "pg": pg,
            "jflow": JaxDeviceSageFlow(jg, **fkw),
            "pflow": DeviceSageFlow(pg, **fkw, device="cpu"),
            "jcache": JaxFeatureCache(jg, ["feat"]),
            "pcache": DeviceFeatureCache(pg, ["feat"], device="cpu"),
        }


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


def _hydrated(setup, key):
    jb = setup["jcache"].hydrate(jax_hydrate_blocks(jax.jit(setup["jflow"].sample)(key)))
    pb = setup["pcache"].hydrate(
        hydrate_blocks(setup["pflow"].make_batch(*_draws(setup["jflow"], key)))
    )
    return jb, pb


def test_skewed_graph_matches_bench():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench

    want = bench._skewed_weighted_graph(500, seed=13)
    got = skewed_weighted_graph(500, seed=13)
    assert got.meta.to_dict() == want.meta.to_dict()
    ws, gs = want.shards[0].arrays, got.shards[0].arrays
    assert sorted(ws) == sorted(gs)
    for k in ws:
        assert gs[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)


def test_hydrate_blocks_match_jax(setup):
    jb, pb = _hydrated(setup, jax.random.PRNGKey(1))
    for a, b in zip(jb.masks, pb.masks):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jb.blocks, pb.blocks):
        for name in ("edge_src", "edge_dst", "edge_w", "mask"):
            want, got = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            assert want.dtype == got.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    for a, b in zip(jb.feats, pb.feats):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("quant", ["f32", "bf16"])
def test_feature_cache_matches_jax(setup, quant):
    jc = JaxFeatureCache(setup["jg"], ["feat"], quant=quant)
    pc = DeviceFeatureCache(setup["pg"], ["feat"], quant=quant, device="cpu")
    assert pc.table.dtype == (torch.bfloat16 if quant == "bf16" else torch.float32)
    np.testing.assert_array_equal(pc.table.float().numpy(), np.asarray(jc.table, np.float32))
    rows = np.array([0, 1, 5, 300, 17], np.int32)
    got = pc.gather(torch.from_numpy(rows))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.gather(jnp.asarray(rows))))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gather_weighted_sum_grads_match_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(23, 16)).astype(np.float32)
    slots = rng.integers(0, 23, (9, 5)).astype(np.int32)  # repeats: dx accumulates
    w = rng.random((9, 5)).astype(np.float32)
    g = rng.normal(size=(9, 16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)

    def f(x_, w_):
        return jnp.sum(jax_gws(x_, jnp.asarray(slots), w_, "xla") * g)

    jdx, jdw = jax.grad(f, argnums=(0, 1))(jx, jnp.asarray(w))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    tx.requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (gather_weighted_sum(tx, torch.from_numpy(slots), tw) * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jdx, np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)


def test_graphsage_loss_metric_and_grads_match_jax(setup):
    jb, pb = _hydrated(setup, jax.random.PRNGKey(2))
    tree = _flax_tree(seed=1)
    model = JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM)

    def loss_fn(p):
        _, loss, _, metric = model.apply(p, jb)
        return loss, metric

    (jloss, jmetric), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    port = GraphSAGESupervised(FEAT, DIMS, LABEL_DIM)
    port.load_state_dict(from_flax(tree))
    _, loss, name, metric = port(pb)
    loss.backward()
    assert name == "f1"
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(metric.item(), float(jmetric), rtol=1e-5, atol=1e-5)
    named = dict(port.named_parameters())
    got = [to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)]
    for a, b in zip(got, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd", "momentum"])
def test_optimizer_updates_and_state_match_optax(name):
    rng = np.random.default_rng(8)
    w0, b0 = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    grads = [(rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=3).astype(np.float32))
             for _ in range(3)]
    cfg = EstimatorConfig(optimizer=name, learning_rate=0.05)
    tx = {"adam": optax.adam(0.05), "adagrad": optax.adagrad(0.05), "sgd": optax.sgd(0.05),
          "momentum": optax.sgd(0.05, momentum=0.9)}[name]
    params = {"out": {"bias": jnp.asarray(b0), "kernel": jnp.asarray(w0.T)}}
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    named = {"out.weight": torch.nn.Parameter(torch.from_numpy(w0.copy())),
             "out.bias": torch.nn.Parameter(torch.from_numpy(b0.copy()))}
    opt = make_optimizer(cfg, list(named.values()))
    for gw, gb in grads:
        params, state = update({"out": {"bias": jnp.asarray(gb), "kernel": jnp.asarray(gw.T)}},
                               state, params)
        named["out.weight"].grad = torch.from_numpy(gw)
        named["out.bias"].grad = torch.from_numpy(gb)
        opt.step()
    np.testing.assert_allclose(named["out.weight"].detach().numpy(),
                               np.asarray(params["out"]["kernel"]).T, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(named["out.bias"].detach().numpy(),
                               np.asarray(params["out"]["bias"]), rtol=1e-6, atol=1e-6)
    want = jax.tree_util.tree_leaves(state)
    got = optimizer_leaves(name, opt, named)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


def _trajectories(setup, optimizer, steps, model_dir, k=1):
    """JAX Estimator and port Estimator from the same flax init, both at
    steps_per_call k; the port is handed JAX's per-step draws (fold_in of
    the flow key per global step, whatever the grouping)."""
    tree = _flax_tree(seed=2)
    cfg = dict(optimizer=optimizer, steps_per_call=k, **CFG)
    jest = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM), setup["jflow"],
                        JaxConfig(model_dir=model_dir + "_jax", **cfg),
                        feature_cache=setup["jcache"],
                        init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    jlosses = jest.train(steps, log=False, save=False)
    flow_key = jax.random.PRNGKey(CFG["seed"] + 2)
    keys = iter([jax.random.fold_in(flow_key, s) for s in range(steps)])
    pflow = setup["pflow"]
    pflow.draw_inputs = lambda gen: _draws(setup["jflow"], next(keys))
    try:
        pest = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), pflow,
                         EstimatorConfig(model_dir=model_dir, **cfg),
                         feature_cache=setup["pcache"], init_params=from_flax(tree), device="cpu")
        plosses = pest.train(steps, log=False, save=False)
    finally:
        del pflow.draw_inputs
    return jest, pest, np.asarray(jlosses), np.asarray(plosses)


def test_sgd_trajectory_matches_jax(setup, tmp_path):
    _, _, jl, pl = _trajectories(setup, "sgd", 5, str(tmp_path / "m"))
    assert len(pl) == 5 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def test_grouped_steps_match_single_steps_and_jax_train_scan(setup, tmp_path):
    """27 sgd steps at K = 8 (3 calls and a remainder of 3) from JAX's
    draws: within 1e-4 relative of the port at K = 1 (the rule of
    tests/test_device_flow.py:258-261; on the CPU they are the same
    steps), and within 1e-5 of JAX's `_train_scan` at K = 8."""
    _, one, _, pl1 = _trajectories(setup, "sgd", 27, str(tmp_path / "k1"))
    _, grouped, jl, pl = _trajectories(setup, "sgd", 27, str(tmp_path / "k8"), k=8)
    assert len(pl) == len(jl) == 27 and np.isfinite(pl).all() and grouped.step == 27
    np.testing.assert_allclose(pl, pl1, rtol=1e-4)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    for (name, a), b in zip(one.model.state_dict().items(),
                            grouped.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def adam_run(setup, tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("adam") / "m")
    return _trajectories(setup, "adam", 3, model_dir)


def test_adam_trajectory_matches_jax(adam_run):
    # Adam's update is m/√v: a near-zero gradient whose sign differs by
    # rounding between the packages becomes a ±lr step, so the losses
    # drift apart by more than the f32 rounding of one forward pass
    _, _, jl, pl = adam_run
    np.testing.assert_allclose(pl, jl, rtol=1e-3, atol=1e-3)


def test_port_checkpoint_restored_by_jax(adam_run):
    jest, pest, _, _ = adam_run
    path = pest.save()
    assert os.path.basename(path) == "ckpt_000000000003"
    jest.cfg.model_dir = pest.cfg.model_dir
    assert jest.restore() and jest.step == 3
    named = dict(pest.model.named_parameters())
    want_p = [to_flax_leaf(k, named[k]) for k in checkpoint_order(named)]
    for a, b in zip(jax.tree_util.tree_leaves(jest.params), want_p):
        np.testing.assert_array_equal(np.asarray(a), b)
    want_o = optimizer_leaves("adam", pest.optimizer, named)
    got_o = jax.tree_util.tree_leaves(jest.opt_state)
    assert len(got_o) == len(want_o) == 1 + 2 * len(named)
    for a, b in zip(got_o, want_o):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_jax_checkpoint_restored_by_port(adam_run, tmp_path):
    jest, pest, _, _ = adam_run
    jest.cfg.model_dir = str(tmp_path / "jax")
    jest.save()
    other = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), pest.flow,
                      EstimatorConfig(model_dir=str(tmp_path / "jax"), optimizer="adam", **CFG),
                      device="cpu")
    assert other.restore() and other.step == jest.step
    named = dict(other.model.named_parameters())
    got_p = [to_flax_leaf(k, named[k]) for k in checkpoint_order(named)]
    for a, b in zip(got_p, jax.tree_util.tree_leaves(jest.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(optimizer_leaves("adam", other.optimizer, named),
                    jax.tree_util.tree_leaves(jest.opt_state)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_port_checkpoint_served_by_port(adam_run, setup):
    _, pest, _, _ = adam_run
    pest.save()
    flow = SageDataFlow(setup["pg"], ["feat"], fanouts=FANOUTS, rng=np.random.default_rng(0))
    rt = InferenceRuntime(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), flow,
                          cfg=pest.cfg, buckets=(8,), device="cpu")
    for k, v in pest.model.state_dict().items():
        assert torch.equal(rt.params[k], v), k
    emb = rt.predict(np.arange(1, 12, dtype=np.uint64))
    assert emb.shape == (11, DIMS[-1]) and np.isfinite(emb).all()


def test_estimator_draws_are_a_function_of_the_step(setup, tmp_path):
    """The port's own draws: step s's batch does not depend on what ran
    before, and two steps differ."""
    est = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), setup["pflow"],
                    EstimatorConfig(model_dir=str(tmp_path / "m"), **CFG),
                    feature_cache=setup["pcache"], device="cpu")
    a, b = est.batch(4), est.batch(5)
    assert torch.equal(est.batch(4).feats[2], a.feats[2])
    assert not torch.equal(a.feats[2], b.feats[2])
    losses = est.train(3, log=False)
    assert len(losses) == 3 and np.isfinite(losses).all() and est.last_losses == losses
    assert os.path.isdir(tmp_path / "m" / "ckpt_000000000003")
