"""euler_tpu_torch training slice against the JAX package: the skewed
graph, batch hydration and the feature cache (bitwise), the
gather_weighted_sum gradients, GraphSAGESupervised's loss, metric and
grads, the optimizers' updates and state leaves, the Estimator's loss
trajectory from the same init and the same draws (steps_per_call 1 and 8
against JAX's step and `_train_scan`), and checkpoints the two packages
read from each other.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from euler_tpu.dataflow import DeviceSageFlow as JaxDeviceSageFlow
from euler_tpu.distributed import codec as jcodec
from euler_tpu.dataflow.base import hydrate_blocks as jax_hydrate_blocks
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.estimator import DeviceFeatureCache as JaxFeatureCache
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.ops.pallas_kernels import gather_weighted_sum as jax_gws
from euler_tpu_torch.dataflow import DeviceSageFlow, SageDataFlow, hydrate_blocks
from euler_tpu_torch.datasets import random_graph, skewed_weighted_graph
from euler_tpu_torch.distributed import codec as pcodec
from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
from euler_tpu_torch.estimator import make_optimizer
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.nn.heads import sigmoid_binary_cross_entropy
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
            "jflow": (jflow := JaxDeviceSageFlow(jg, **fkw)),
            # one jitted sample for the module: a fresh jax.jit retraces
            # and recompiles the whole draw (~2 s)
            "jsample": jax.jit(jflow.sample),
            "hydrated": {},
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


def _hydrated(setup, seed: int):
    """The hydrated batches of PRNGKey(seed) in both packages, made once
    a module (JAX's hydration as one jitted program: op by op, each gather
    and mask would compile on its own)."""
    if seed not in setup["hydrated"]:
        key = jax.random.PRNGKey(seed)
        jcache = setup["jcache"]
        jb = jax.jit(lambda b: jcache.hydrate(jax_hydrate_blocks(b)))(setup["jsample"](key))
        pb = setup["pcache"].hydrate(
            hydrate_blocks(setup["pflow"].make_batch(*_draws(setup["jflow"], key))))
        setup["hydrated"][seed] = jb, pb
    return setup["hydrated"][seed]


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
    jb, pb = _hydrated(setup, 1)
    for a, b in zip(jb.masks, pb.masks):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jb.blocks, pb.blocks):
        for name in ("edge_src", "edge_dst", "edge_w", "mask"):
            want, got = np.asarray(getattr(a, name)), getattr(b, name).numpy()
            assert want.dtype == got.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    for a, b in zip(jb.feats, pb.feats):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _planes(cache) -> list[np.ndarray]:
    """A cache's table (bf16 widened to f32) and, for int8, its scale and
    zero planes, as numpy: either package's cache."""
    t = cache.table
    if cache.quant == "bf16":
        t = t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32)
    return [np.asarray(p) for p in [t] + ([cache._scale, cache._zero]
                                          if cache.quant == "int8" else [])]


@pytest.mark.parametrize("quant", ["f32", "bf16", "int8"])
def test_feature_cache_matches_jax(setup, quant):
    """Tables, int8 scale / zero planes and `stage_chunk_rows` staging
    bitwise against JAX's cache; gathers bitwise (int8: within 1 ulp, as
    XLA may contract q·scale + zero to an fma, and within the codec's
    budget of the f32 rows); `_patch` requantizes as JAX's does."""
    jc = JaxFeatureCache(setup["jg"], ["feat"], quant=quant)
    pc = DeviceFeatureCache(setup["pg"], ["feat"], quant=quant, device="cpu")
    want_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.uint8}[quant]
    assert pc.table.dtype == want_dtype
    chunked = DeviceFeatureCache(setup["pg"], ["feat"], quant=quant, stage_chunk_rows=64,
                                 device="cpu")
    jchunked = JaxFeatureCache(setup["jg"], ["feat"], quant=quant, stage_chunk_rows=64)
    for a, b, c, d in zip(_planes(pc), _planes(jc), _planes(chunked), _planes(jchunked)):
        for x in (b, c, d):
            np.testing.assert_array_equal(a, x)
    rows = np.array([0, 1, 5, 300, 17], np.int32)
    got = pc.gather(torch.from_numpy(rows))
    assert got.dtype == torch.float32
    want = np.asarray(jc.gather(jnp.asarray(rows)))
    if quant == "int8":
        np.testing.assert_array_equal(got[0].numpy(), np.zeros(FEAT, np.float32))
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
        f32 = DeviceFeatureCache(setup["pg"], ["feat"], quant="f32", device="cpu")
        exact = f32.gather(torch.from_numpy(rows)).numpy()
        budget = pcodec.quant_error_budget("int8", exact)
        assert np.all(np.abs(got.numpy() - exact) <= budget[:, None] + 1e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    patch_rows = np.array([3, 9], np.int32)
    vals = np.random.default_rng(5).normal(size=(2, FEAT)).astype(np.float32)
    pc._patch(torch.from_numpy(patch_rows), vals)
    jc._patch(jnp.asarray(patch_rows), vals)
    for a, b in zip(_planes(pc), _planes(jc)):
        np.testing.assert_array_equal(a, b)


def test_feature_cache_dtype_wins_over_quant(setup):
    """A non-f32 `dtype` wins over `quant`, as in JAX: a bf16 table
    gathered as bf16."""
    jc = JaxFeatureCache(setup["jg"], ["feat"], dtype=jnp.bfloat16, quant="int8")
    pc = DeviceFeatureCache(setup["pg"], ["feat"], dtype=torch.bfloat16, quant="int8",
                            device="cpu")
    assert pc.quant == jc.quant == "f32" and pc.table.dtype == torch.bfloat16
    rows = np.array([0, 2, 299], np.int32)
    got = pc.gather(torch.from_numpy(rows))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jc.gather(jnp.asarray(rows)), np.float32))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_codec_quantize_matches_jax(kind):
    """The port's copy of `codec.quantize` / `dequantize` /
    `quant_error_budget` against the JAX package's: int8 q, scale and
    zero bitwise, bf16 bits equal (torch's round-to-nearest-even against
    ml_dtypes'), the same budgets; rows far from 0, a constant row and
    subnormals included."""
    rng = np.random.default_rng(11)
    vals = (rng.normal(size=(40, 24)) * rng.uniform(1e-3, 1e3, (40, 1))).astype(np.float32)
    vals[3] += np.float32(5e4)
    vals[4] = np.float32(2.5)
    vals[5, :4] = np.float32(1e-40)
    got, want = pcodec.quantize(kind, vals), jcodec.quantize(kind, vals)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if kind == "bf16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(b).view(np.uint16))
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    back = pcodec.dequantize(kind, got)
    np.testing.assert_array_equal(back, jcodec.dequantize(kind, want))
    budget = pcodec.quant_error_budget(kind, vals)
    np.testing.assert_array_equal(budget, jcodec.quant_error_budget(kind, vals))
    assert np.all(np.abs(back - vals) <= budget[:, None])
    with pytest.raises(ValueError):
        pcodec.dequantize("int8", got[:1])


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

    jdx, jdw = jax.jit(jax.grad(f, argnums=(0, 1)))(jx, jnp.asarray(w))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    tx.requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (gather_weighted_sum(tx, torch.from_numpy(slots), tw) * torch.from_numpy(g)).sum().backward()
    assert tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jdx, np.float32),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)


def test_graphsage_loss_metric_and_grads_match_jax(setup):
    jb, pb = _hydrated(setup, 2)
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


def test_remat_matches_exact(setup, tmp_path):
    """The twin of tests/test_training.py:196-223: remat=True changes no
    number. One step's loss and grads under remat against JAX's remat
    model (1e-5) and against the port without remat (rtol 1e-6 / atol
    1e-7); then 4 adam steps of the paged lane with the feature cache, at
    steps_per_call 1 and 2, against 4 steps without remat."""
    jb, pb = _hydrated(setup, 2)
    tree = _flax_tree(seed=1)
    jmodel = JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM, remat=True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply(p, jb)[1:4:2], has_aux=True))(tree)
    grads = []
    for remat in (False, True):
        port = GraphSAGESupervised(FEAT, DIMS, LABEL_DIM, remat=remat)
        port.load_state_dict(from_flax(tree))
        loss = port(pb)[1]
        loss.backward()
        named = dict(port.named_parameters())
        grads.append([to_flax_leaf(k, named[k].grad) for k in checkpoint_order(named)])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    for a, b, c in zip(grads[1], grads[0], jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-5, atol=1e-5)

    def run(remat, k):
        est = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM, remat=remat), setup["pflow"],
                        EstimatorConfig(model_dir=str(tmp_path), steps_per_call=k, **CFG),
                        feature_cache=setup["pcache"], init_params=from_flax(tree),
                        device="cpu")
        return np.asarray(est.train(4, log=False, save=False)), est.model.state_dict()

    want, want_p = run(False, 1)
    for k in (1, 2):
        got, got_p = run(True, k)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        for name, v in want_p.items():
            np.testing.assert_allclose(got_p[name].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_sigmoid_loss_and_grad_match_optax():
    """`nn.heads.sigmoid_binary_cross_entropy` against
    optax.sigmoid_binary_cross_entropy under jax.grad: logits spread to
    +-40 (entries past |x| = 17, where torch's fused BCE-with-logits
    rounds the gradient to 0), 0/1 labels; loss and gradient within 1e-6
    relative."""
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.uniform(-40, 40, (64, 7)), rng.normal(0, 12, (64, 7))])
    x[0, :6] = [17.5, -17.5, 40.0, -40.0, 0.0, 25.0]
    x = x.astype(np.float32)
    z = (rng.random(x.shape) < 0.3).astype(np.float32)
    z[0, :4] = 1.0
    assert (np.abs(x) > 17).sum() > 100
    loss = functools.partial(optax.sigmoid_binary_cross_entropy, labels=jnp.asarray(z))
    want, want_g = (np.asarray(a) for a in jax.jit(
        lambda v: (loss(v), jax.grad(lambda u: jnp.sum(loss(u)))(v)))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = sigmoid_binary_cross_entropy(tx, torch.from_numpy(z))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tx.grad.numpy(), want_g, rtol=1e-6, atol=1e-12)
    assert tx.grad[0, 0] != 0  # x = 17.5, z = 1: -3.9e-10, not rounded away


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
