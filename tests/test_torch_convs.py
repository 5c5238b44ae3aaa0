"""The conv zoo on the port against the JAX package: GCN, GAT, APPNP, SGCN,
TAGCN, ARMA, GraphConv, GIN, AGNN, DNA, GatedGraph, GeniePath and LGCN
(forward and grads of params and inputs, fed the flax conv's params
through `params.from_flax`, on a grid block and a non-grid block; LGCN,
which needs a grid, on the grid block and on a block of tied values),
the message-passing ops behind them
(scatter_mean, scatter_max with ties, scatter_softmax with an empty
segment), FullNeighborDataFlow(gcn_norm=True) and FullGraphFlow bitwise on
the numpy and the native store, 3-step SuperviseModel trainings of GCN
(full-graph flow) and GAT (host sampled flow), the flax param trees of
every conv mapped both ways, `params.flax_init` against flax's init, and
checkpoints both ways.

The JAX side runs in pallas mode 'auto', which on the CPU takes
gather_weighted_sum's plain reference; the port runs in kernel mode
'auto', which on CPU tensors takes the kernel's plain version.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
import euler_tpu.layers as jax_layers
from euler_tpu import ops as jax_ops
from euler_tpu.dataflow import FullGraphFlow as JaxFullGraphFlow
from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageFlow
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.nn import SuperviseModel as JaxSuperviseModel
from euler_tpu.ops import mp_ops as jax_mp
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import FullGraphFlow, FullNeighborDataFlow, SageDataFlow, to_device
from euler_tpu_torch.datasets import cora_like_json
from euler_tpu_torch.estimator import Estimator, EstimatorConfig, stack_batches
from euler_tpu_torch.graph import Graph, convert_json, native
from euler_tpu_torch.layers import CONVS
from euler_tpu_torch.nn import SuperviseModel
from euler_tpu_torch.nn.base_gnn import call_layer
from euler_tpu_torch.ops import mp_ops
from euler_tpu_torch.params import (
    checkpoint_order,
    flax_init,
    from_flax,
    init_like_flax,
    to_flax_leaf,
)

torch.set_num_threads(1)

FEAT, CLASSES, FANOUTS, MAX_DEGREE = 16, 7, [3, 2], 4
TOL = dict(rtol=1e-5, atol=1e-5)
# roots of the sampled batches: 10**9 is not in the graph (every slot of
# its row is masked), 7 repeats
ROOTS = np.asarray([1, 7, 7, 150, 10**9, 33], np.uint64)
PORTED = ("gcn", "gat", "graph", "appnp", "sgcn", "tagcn", "arma",
          "gin", "agnn", "dna", "gated", "geniepath", "lgcn")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A small cora stand-in (7 classes, 16-wide features, degrees from 0
    up) as one graph dir, loaded by both packages from the numpy store."""
    d = str(tmp_path_factory.mktemp("cora"))
    convert_json(cora_like_json(num_nodes=300, feature_dim=FEAT, train_per_class=5, val_n=20,
                                test_n=20), d)
    return d, JaxGraph.load(d, native=False), Graph.load(d, native=False)


@pytest.fixture(scope="module")
def batches(data):
    """The same host batches from both packages (bitwise, see the flow
    tests): a sampled batch (grid blocks) and a full-neighbor batch with
    true degrees; JAX MiniBatches and port MiniBatches on the CPU."""
    _, jg, pg = data
    out = {}
    for kind, jcls, pcls, kw in (
        ("sampled", JaxSageFlow, SageDataFlow, dict(fanouts=FANOUTS, label_feature="label")),
        ("degrees", JaxFullFlow, FullNeighborDataFlow,
         dict(num_hops=2, max_degree=MAX_DEGREE, gcn_norm=True)),
    ):
        jb = jcls(jg, ["feature"], rng=np.random.default_rng(3), **kw).query(ROOTS)
        pb = pcls(pg, ["feature"], rng=np.random.default_rng(3), **kw).query(ROOTS)
        out[kind] = (jb, to_device(pb, "cpu"))
    return out


class _JaxMode:
    """JAX pallas mode 'auto' for a block of code."""

    def __enter__(self):
        self.prev = jax_ops.pallas_mode()
        jax_ops.set_pallas("auto")

    def __exit__(self, *exc):
        jax_ops.set_pallas(self.prev)


def _random_params(module, seed, *args):
    """A flax param tree of `module` (its structure traced, not run) with
    seeded normal leaves: N(0, 1/fan_in) kernels, N(0, 0.1) biases and
    attention vectors."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(s):
        std = s.shape[0] ** -0.5 if len(s.shape) == 2 and s.shape[0] > 8 else 0.3
        return rng.normal(0, std, s.shape).astype(np.float32)

    return jax.tree_util.tree_map(leaf, shapes)


# (conv, kwargs, block): "grid" is hop 0 of the sampled batch, "scatter"
# the same block with its grid cleared (the segment-op path), "degrees"
# hop 0 of the full-neighbor batch (GCN's true-degree branch), "ties" the
# grid block over relu'd inputs whose rows repeat (LGCN's top-k ties); an
# `out_dim` kwarg sets the conv's width (GatedGraph pads x_dst to it when
# it is wider than the input, cuts x_dst to it otherwise)
CASES = [(c, {}, b) for c in PORTED if c not in ("gat", "lgcn") for b in ("grid", "scatter")] + [
    ("gcn", {}, "degrees"),
    ("gat", {}, "grid"),
    ("gat", {}, "scatter"),
    ("gat", {"improved": True}, "grid"),
    ("gat", {"heads": 4}, "grid"),
    ("gat", {"heads": 4, "concat": False, "improved": True}, "grid"),
    ("gat", {"heads": 4, "concat": False}, "scatter"),
    ("gin", {"eps_init": 0.3, "hidden_dim": 12}, "grid"),
    ("gated", {"out_dim": 24}, "grid"),
    ("gated", {"out_dim": 24}, "scatter"),
    ("lgcn", {}, "grid"),
    ("lgcn", {"k": 2, "hidden_dim": 16}, "ties"),
    ("agnn", {}, "ties"),
]
OUT = 8


def _ids(case):
    conv, kw, block = case
    return "-".join([conv, block] + [f"{k}={v}" for k, v in kw.items()])


def _block_pair(batches, kind):
    jb, pb = batches["degrees" if kind == "degrees" else "sampled"]
    jblk, pblk = jb.blocks[0], pb.blocks[0]
    if kind == "scatter":
        jblk, pblk = jblk.replace(grid=0), dataclasses.replace(pblk, grid=0)
    xd, xs = np.asarray(jb.feats[0]), np.asarray(jb.feats[1])
    if kind == "ties":
        # relu'd rows (exact zeros tie in every channel), each src row
        # repeated by its neighbour slot's successor: every dst row holds
        # equal values in the same channel at several slots
        xd, xs = np.maximum(xd, 0), np.maximum(xs, 0)
        xs[1::2] = xs[0::2]
        xs[:, ::3] = 0
    return (xd, xs, jblk), (torch.from_numpy(xd), torch.from_numpy(xs), pblk)


def _split(kw):
    """(conv kwargs, output width) of a case."""
    kw = dict(kw)
    return kw, kw.pop("out_dim", OUT)


@pytest.fixture(scope="module")
def flax_convs(batches):
    """The flax side of a case, (params, cotangent, output, grads), one
    jit each, memoized by what the flax conv reads: the convs other than
    GAT never read `grid`, so their grid and non-grid cases share one."""
    memo = {}

    def get(conv, kw, kind):
        if conv != "gat" and kind == "scatter":
            kind = "grid"
        key = (conv, tuple(sorted(kw.items())), kind)
        if key in memo:
            return memo[key]
        (jxd, jxs, jblk), _ = _block_pair(batches, kind)
        kw, out = _split(kw)
        module = getattr(jax_layers, CONVS[conv].__name__)(out_dim=out, **kw)
        with _JaxMode():
            params = _random_params(module, 5, jxd, jxs, jblk).get("params", {})
            width = jax.eval_shape(module.apply, {"params": params}, jxd, jxs, jblk).shape[1]
            cot = np.random.default_rng(9).normal(size=(jblk.n_dst, width)).astype(np.float32)

            @jax.jit
            def fwd_bwd(p, xd, xs, cot):
                out, vjp = jax.vjp(lambda p, a, b: module.apply({"params": p}, a, b, jblk),
                                   p, xd, xs)
                return out, vjp(cot)

            memo[key] = (params, cot, *fwd_bwd(params, jxd, jxs, jnp.asarray(cot)))
        return memo[key]

    return get


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_conv_forward_and_grads_match_flax(case, batches, flax_convs):
    """Each conv's output and the grads of its params and of both inputs
    (a random cotangent) against the flax conv with the same params; then
    under remat (`call_layer`) against itself."""
    conv, kw, kind = case
    _, (pxd, pxs, pblk) = _block_pair(batches, kind)
    params, cot, want, (gp, gxd, gxs) = flax_convs(conv, kw, kind)
    width = cot.shape[1]

    ckw, out = _split(kw)
    port = CONVS[conv](FEAT, out, **ckw)
    assert port.out_width == width
    port.load_state_dict(from_flax({"params": params}))
    xd, xs = pxd.clone().requires_grad_(), pxs.clone().requires_grad_()
    got = port(xd, xs, pblk)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    gxd, gxs = np.asarray(gxd), np.asarray(gxs)
    if conv == "agnn":
        # jnp.linalg.norm's gradient at a zero row is NaN (the absent root's
        # features, relu-killed rows); the port's is the subgradient 0,
        # which leaves d(x / (|x| + 1e-9))/dx = 1e9·I there
        zero_d, zero_s = ~pxd.numpy().any(axis=1), ~pxs.numpy().any(axis=1)
        assert zero_d.any() and np.isnan(gxd[zero_d]).all() and np.isnan(gxs[zero_s]).all()
        assert np.isfinite(xd.grad.numpy()).all() and np.isfinite(xs.grad.numpy()).all()
        gxd = np.where(zero_d[:, None], xd.grad.numpy(), gxd)
        gxs = np.where(zero_s[:, None], xs.grad.numpy(), gxs)
    np.testing.assert_allclose(xd.grad.numpy(), gxd, **TOL)
    np.testing.assert_allclose(xs.grad.numpy(), gxs, **TOL)
    want_p = from_flax({"params": gp})
    assert sorted(want_p) == sorted(n for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_p[name].numpy(), err_msg=name, **TOL)
    if conv == "gat" and kind == "grid" and kw.get("heads", 1) == 1 and not kw:
        # the all-masked row (the absent root) attends to nothing
        assert not got[4].any()
    # remat: the same numbers, and no draw from torch's generator (the
    # recompute keeps no RNG state)
    rng_state = torch.random.get_rng_state()
    grads = [xd.grad, xs.grad] + [p.grad for p in port.parameters()]
    port.zero_grad(set_to_none=True)
    xd, xs = pxd.clone().requires_grad_(), pxs.clone().requires_grad_()
    again = call_layer(port, True, xd, xs, pblk)
    again.backward(torch.from_numpy(cot))
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    np.testing.assert_allclose(again.detach().numpy(), got.detach().numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip([xd.grad, xs.grad] + [p.grad for p in port.parameters()], grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def _mp_inputs():
    """A [10, 3] input over 5 segments: segment 3 is empty, segment 1 has
    every row masked, segment 0 ties for its max in two rows."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=(10, 3)).astype(np.float32)
    data[2] = data[0]
    seg = np.asarray([0, 0, 0, 1, 1, 2, 2, 4, 4, 4], np.int32)
    mask = np.asarray([1, 1, 1, 0, 0, 1, 1, 1, 0, 1], bool)
    cot = rng.normal(size=(10, 3)).astype(np.float32)
    return data, seg, mask, cot


@pytest.mark.parametrize("op", ["mean", "max", "softmax", "add"])
@pytest.mark.parametrize("masked", [False, True])
def test_scatter_ops_match_jax(op, masked):
    data, seg, mask, cot = _mp_inputs()
    m = mask if masked else None
    n = 5
    jfn = {"mean": jax_mp.scatter_mean, "max": jax_mp.scatter_max,
           "softmax": jax_mp.scatter_softmax, "add": jax_mp.scatter_add}[op]
    cot = cot if op == "softmax" else cot[:n]

    @jax.jit
    def fwd_bwd(x, cot):
        out, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(seg), n, mask=m), x)
        return out, vjp(cot)[0]

    want, want_g = fwd_bwd(jnp.asarray(data), jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_()
    got = mp_ops.scatter(op, x, torch.from_numpy(seg), n,
                         mask=None if m is None else torch.from_numpy(m))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    if op == "max":
        # the tie in segment 0 splits its gradient equally, column by column
        tied = data[0] == data[0:3].max(axis=0)
        np.testing.assert_array_equal(x.grad.numpy()[0][tied], x.grad.numpy()[2][tied])
        assert not got[3].any()  # the empty segment


def _assert_batches_equal(jb, pb):
    """Every field of two MiniBatches bitwise (degrees and target_idx
    included)."""
    for name in ("feats", "masks", "hop_ids"):
        a, b = getattr(jb, name), getattr(pb, name)
        assert (a is None) == (b is None), name
        for x, y in zip(a or (), b or ()):
            x = np.asarray(x)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(y, x, err_msg=name)
    for name in ("root_idx", "labels", "target_idx"):
        x, y = getattr(jb, name), getattr(pb, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.asarray(x).dtype == y.dtype, name
            np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)
    assert len(jb.blocks) == len(pb.blocks)
    for a, b in zip(jb.blocks, pb.blocks):
        assert (a.n_src, a.n_dst, a.grid) == (b.n_src, b.n_dst, b.grid)
        for name in ("edge_src", "edge_dst", "edge_w", "mask", "src_deg", "dst_deg"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert np.asarray(x).dtype == y.dtype, name
                np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)


@pytest.fixture(scope="module")
def engine():
    """The port's native engine, built once; the JAX binding is pointed
    at it, so no test writes the JAX package's library."""
    path = native.build_engine()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "build_engine", lambda force=False: path)
    mp.setattr(jax_native, "_lib", None)
    yield path
    mp.undo()


@pytest.mark.parametrize("store", ["numpy", "native"])
def test_full_graph_flows_match_jax(store, data, request):
    """FullNeighborDataFlow(gcn_norm=True) and FullGraphFlow (true degrees,
    and with self loops) batches bitwise on both stores."""
    d, jg, pg = data
    if store == "native":
        request.getfixturevalue("engine")
        jg, pg = JaxGraph.load(d, native=True), Graph.load(d, native=True)
        assert type(pg.shards[0]).__name__ == "NativeGraphStore"
    roots = np.asarray([1, 7, 7, 150, 299, 33], np.uint64)
    kw = dict(num_hops=2, max_degree=MAX_DEGREE, label_feature="label", gcn_norm=True)
    _assert_batches_equal(JaxFullFlow(jg, ["feature"], **kw).query(roots),
                          FullNeighborDataFlow(pg, ["feature"], **kw).query(roots))
    for loops in (False, True):
        jf = JaxFullGraphFlow(jg, ["feature"], "label", add_self_loops=loops)
        pf = FullGraphFlow(pg, ["feature"], "label", add_self_loops=loops)
        _assert_batches_equal(jf.query(roots), pf.query(roots))
    with pytest.raises(ValueError, match="not in the graph"):
        pf.query(np.asarray([10**9], np.uint64))
    # the degrees and target rows ride to_device and stack_batches; the
    # node table the batch holds once a hop is moved once
    pb = pf.query(roots)
    moved = to_device(pb, "cpu")
    assert moved.feats[0] is moved.feats[2] and moved.target_idx is moved.root_idx
    (stacked,) = stack_batches(lambda: (pf.query(roots),), 2)()
    assert stacked.target_idx.shape == (2, len(roots)) and stacked.blocks[0].src_deg is None
    pb = FullGraphFlow(pg, ["feature"], "label").query(roots)
    (stacked,) = stack_batches(lambda: (pb,), 2)()
    np.testing.assert_array_equal(stacked.blocks[1].dst_deg[1], pb.blocks[1].dst_deg)


def _jax_init(conv, kw, dims, jb):
    model = JaxSuperviseModel(conv=conv, dims=dims, label_dim=CLASSES, conv_kwargs=kw)
    with _JaxMode():
        return model, _random_params(model, 2, jb)


MODEL_KW = {"gat": {"heads": 2, "improved": True}, "arma": {"stacks": 3},
            "gin": {"eps_init": 0.25}, "lgcn": {"k": 2, "hidden_dim": 16}}


@pytest.mark.parametrize("conv", PORTED)
def test_param_trees_map_both_ways(conv, batches):
    """The flax SuperviseModel tree of each conv loads into the port's
    SuperviseModel (the width chain: APPNP, SGCN and AGNN pass their input
    width on) and comes back as the same leaves in the same order,
    bitwise; the port's flax-like init draws a tree of the same shapes."""
    jb, _ = batches["sampled"]
    _, tree = _jax_init(conv, MODEL_KW.get(conv), [8, 8], jb)
    model = SuperviseModel(FEAT, conv, [8, 8], CLASSES, conv_kwargs=MODEL_KW.get(conv))
    sd = from_flax(tree)
    model.load_state_dict(sd)
    leaves, _ = jax.tree_util.tree_flatten(tree)
    keys = checkpoint_order(model.state_dict())
    assert len(keys) == len(leaves)
    for k, leaf in zip(keys, leaves):
        got = to_flax_leaf(k, model.state_dict()[k])
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, k
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=k)
    init = init_like_flax(model, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in sd.items()}
    if conv == "gat":  # lecun_normal over [heads, per]: fan_in = heads
        att = torch.cat([init[k].reshape(-1) for k in init if "att_" in k])
        assert 0 < att.std() < 2 * (1 / 2) ** 0.5
    for k, v in init.items():
        if k.endswith(".eps"):
            assert float(v) == 0.25
        if k.endswith(".beta"):
            assert float(v) == 1.0
        if "." + k.split(".")[-2] in (".hr", ".hz", ".hn", ".hi", ".hf", ".hg", ".ho") \
                and k.endswith("weight"):  # orthogonal
            torch.testing.assert_close(v @ v.T, torch.eye(v.shape[0]), rtol=0, atol=1e-5)
    if conv == "lgcn":
        with pytest.raises(ValueError, match="needs a grid"):
            _, (pxd, pxs, pblk) = _block_pair(batches, "scatter")
            model.gnn.convs[0](pxd, pxs, pblk)


# orthogonal kernels (the recurrent cells' hidden Denses): numpy factors
# the normal draw in f64, XLA in f32
ORTHO_ATOL = 5e-6


def _assert_flax_init(got, want, conv):
    """Every lecun_normal leaf within 2 ulp (numpy's log1p inside XLA's
    erf_inv rounds to the other neighbour now and then), every
    orthogonal one within ORTHO_ATOL."""
    assert sorted(got) == sorted(want)
    differ = ortho = 0
    for k in got:
        if k.split(".")[-2:-1] in (["hr"], ["hz"], ["hn"], ["hi"], ["hf"], ["hg"], ["ho"]) \
                and k.endswith("weight"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=ORTHO_ATOL,
                                       err_msg=k)
            ortho += 1
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2.5e-7, atol=0,
                                   err_msg=k)
        differ += int((got[k] != want[k]).sum())
    assert differ <= 0.05 * sum(v.numel() for v in got.values())
    assert ortho == {"gated": 3, "geniepath": 4}.get(conv, 0)


def test_flax_init_draws_the_jax_init(batches):
    """`params.flax_init` against the params the JAX Estimator draws
    (`model.init` under split(PRNGKey(seed), 1)[0]) for GAT's
    SuperviseModel, whose tree holds the Dense kernels with and without a
    bias and the attention vectors under `gnn/convs_<l>` and the head;
    the other convs' Dense_<j> paths are `test_param_trees_map_both_ways`'s."""
    jb, _ = batches["sampled"]
    model, _ = _jax_init("gat", MODEL_KW["gat"], [8, 8], jb)
    seed = 3
    with _JaxMode():
        key = jax.random.split(jax.random.PRNGKey(seed), 1)[0]
        # lazy_init traces the forward on shapes alone; the initializers run
        shapes = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype), jb)
        want = from_flax(jax.tree_util.tree_map(np.asarray,
                                                model.lazy_init({"params": key}, shapes)))
    got = flax_init(SuperviseModel(FEAT, "gat", [8, 8], CLASSES, conv_kwargs=MODEL_KW["gat"]),
                    seed)
    _assert_flax_init(got, want, "gat")


@pytest.mark.parametrize("conv", ["gin", "gated", "geniepath", "lgcn", "agnn"])
def test_flax_init_draws_the_jax_conv_init(conv, batches):
    """`params.flax_init` of a bare conv against flax's init of its flax
    twin under one key: GIN's tree holds its `eps`, GatedGraph's and
    GeniePath's the recurrent cells (input kernels lecun_normal, hidden
    ones orthogonal), LGCN's the Conv kernels (fan_in = k·in), AGNN's its
    `beta`."""
    (jxd, jxs, jblk), _ = _block_pair(batches, "grid")
    kw = MODEL_KW.get(conv, {})
    module = getattr(jax_layers, CONVS[conv].__name__)(out_dim=OUT, **kw)
    seed = 4
    with _JaxMode():
        key = jax.random.split(jax.random.PRNGKey(seed), 1)[0]
        want = from_flax(jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda k, a, b: module.init({"params": k}, a, b, jblk))(
                key, jxd, jxs)))
    _assert_flax_init(flax_init(CONVS[conv](FEAT, OUT, **kw), seed), want, conv)


def _pair(kind, data, tmp, optimizer="adam"):
    """A JAX and a port Estimator from one flax init: GCN over
    FullGraphFlow(gcn_norm=True) on the 35 train nodes, GAT (one head,
    improved: the grid path) over host SageDataFlow batches."""
    _, jg, pg = data
    conv, kw = kind
    if conv == "gcn":
        tr = np.arange(1, 36, dtype=np.uint64)
        jf, pf = (cls(g, ["feature"], "label") for cls, g in
                  ((JaxFullGraphFlow, jg), (FullGraphFlow, pg)))
        jfn, pfn = (lambda: (jf.query(tr),)), (lambda: (pf.query(tr),))
        probe = jf.query(tr)
    else:
        jf, pf = (cls(g, ["feature"], fanouts=FANOUTS, label_feature="label",
                      rng=np.random.default_rng(4)) for cls, g in
                  ((JaxSageFlow, jg), (SageDataFlow, pg)))
        rj, rp = np.random.default_rng(5), np.random.default_rng(5)
        jfn = lambda: (jf.query(rj.integers(1, 301, 16).astype(np.uint64)),)  # noqa: E731
        pfn = lambda: (pf.query(rp.integers(1, 301, 16).astype(np.uint64)),)  # noqa: E731
        probe = JaxSageFlow(jg, ["feature"], fanouts=FANOUTS, label_feature="label",
                            rng=np.random.default_rng(0)).query(ROOTS)
    model, tree = _jax_init(conv, kw, [8, 8], probe)
    cfg = dict(learning_rate=0.05, optimizer=optimizer, log_steps=10**9, seed=1)
    jest = JaxEstimator(model, jfn, JaxConfig(model_dir=f"{tmp}/jax", **cfg),
                        init_params=tree)
    pest = Estimator(SuperviseModel(FEAT, conv, [8, 8], CLASSES, conv_kwargs=kw), pfn,
                     EstimatorConfig(model_dir=f"{tmp}/port", **cfg),
                     init_params=from_flax(tree), device="cpu")
    return jest, pest


TRAINED = [("gcn", None), ("gat", {"improved": True})]


@pytest.fixture(scope="module", params=TRAINED, ids=[c for c, _ in TRAINED])
def trained(request, data, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(request.param[0]))
    jest, pest = _pair(request.param, data, tmp)
    with _JaxMode():
        jl = jest.train(3, log=False, save=False)
    pl = pest.train(3, log=False, save=False)
    return request.param, jest, pest, np.asarray(jl), np.asarray(pl), tmp


def test_supervise_model_trains_as_jax(trained):
    """3 adam steps of SuperviseModel: the losses within 1e-5."""
    _, jest, pest, jl, pl = trained[:5]
    assert len(pl) == 3 and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def test_checkpoints_both_ways(trained, data):
    """The port's checkpoint restored by a fresh JAX Estimator, and the
    JAX one by a fresh port Estimator: param and optimizer leaves bitwise
    the writer's."""
    kind, jest, pest, _, _, tmp = trained
    pest.save()
    jest.save()
    jnew, pnew = _pair(kind, data, f"{tmp}/restored")
    jnew.cfg.model_dir, pnew.cfg.model_dir = pest.cfg.model_dir, jest.cfg.model_dir
    with _JaxMode():
        assert jnew.restore() and pnew.restore()
    assert jnew.step == pnew.step == 3
    for reader, writer in ((jnew, pest), (pnew, jest)):
        if isinstance(writer, Estimator):
            want_p, want_o = writer.state_leaves()
            got_p = jax.tree_util.tree_leaves(reader.params)
            got_o = jax.tree_util.tree_leaves(reader.opt_state)
        else:
            want_p = jax.tree_util.tree_leaves(writer.params)
            want_o = jax.tree_util.tree_leaves(writer.opt_state)
            got_p, got_o = reader.state_leaves()
        assert len(got_p) == len(want_p) and len(got_o) == len(want_o)
        for g, w in zip(list(got_p) + list(got_o), list(want_p) + list(want_o)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
