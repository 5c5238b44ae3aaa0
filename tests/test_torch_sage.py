"""euler_tpu_torch SAGEConv, GNNNet and GraphSAGESupervised against the
JAX package, with the flax params carried across by `params.from_flax`.

Port kernel mode 'off' (scatter path) is held against JAX
set_pallas("off"); port 'ref' (the fused grid path through the plain
gather_weighted_sum) against JAX set_pallas("interpret"). bf16 convs
(conv_kwargs={"dtype": bfloat16}) are held against flax's Dense(dtype=
bfloat16) on the fused grid path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.ops as jax_ops
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.datasets.synthetic import random_graph as jax_random_graph
from euler_tpu.layers import degrees as jax_degrees
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import SageDataFlow, to_device
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.layers import SAGEConv, degrees
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.nn import GNNNet
from euler_tpu_torch.params import from_flax

torch.set_num_threads(1)

FEAT, DIMS, LABEL_DIM, FANOUTS = 12, [16, 16], 2, [3, 2]
TOL = 1e-4
MODES = [("off", "off"), ("ref", "interpret")]  # (port, JAX)


def _dense(rng, fan_in, fan_out):
    return {
        "kernel": rng.normal(0, fan_in**-0.5, (fan_in, fan_out)).astype(np.float32),
        "bias": rng.normal(0, 0.1, fan_out).astype(np.float32),
    }


def _flax_tree(seed=0):
    """A flax-shaped GraphSAGESupervised param tree with non-zero biases."""
    rng = np.random.default_rng(seed)
    return {"params": {
        "net": {"gnn": {
            "convs_0": {"Dense_0": _dense(rng, 2 * FEAT, DIMS[0])},
            "convs_1": {"Dense_0": _dense(rng, 2 * DIMS[0], DIMS[1])},
        }},
        "out": _dense(rng, DIMS[1], LABEL_DIM),
    }}


def _batches():
    """The same host batch from both packages' flows (bit-identical, see
    test_torch_graph_flow.py): JAX MiniBatch, port MiniBatch on the CPU.
    Root 10**9 is absent from the graph (its neighbor slots are all
    masked) and 7 repeats."""
    roots = np.asarray([1, 7, 7, 150, 10**9], np.uint64)
    kw = dict(num_nodes=200, out_degree=4, feat_dim=FEAT, seed=6)
    jf = JaxSageDataFlow(jax_random_graph(**kw), ["feat"], fanouts=FANOUTS,
                         rng=np.random.default_rng(3))
    pf = SageDataFlow(random_graph(**kw), ["feat"], fanouts=FANOUTS,
                      rng=np.random.default_rng(3))
    return jf.query(roots), to_device(pf.query(roots), "cpu")


def _run_jax(mode, fn):
    """fn() under JAX pallas mode `mode`, restoring the process-global
    mode afterwards."""
    prev = jax_ops.pallas_mode()
    jax_ops.set_pallas(mode)
    try:
        return np.asarray(fn())
    finally:
        jax_ops.set_pallas(prev)


def _run_port(mode, fn):
    prev = ops.kernel_mode()
    ops.set_kernel_mode(mode)
    try:
        with torch.inference_mode():
            return fn()
    finally:
        ops.set_kernel_mode(prev)


@pytest.fixture(scope="module")
def jax_sage():
    """One JAX GraphSAGESupervised apply per pallas mode, shared by the
    conv test and the GNN test (each interpreted Pallas kernel costs
    seconds to lower; the apply is jitted, so it is traced and lowered
    once, not op by op): the batch pair, the params, and per mode the
    embeddings, the logits and the first conv's output on hop 0, which
    flax's capture_intermediates records from inside the same apply."""
    jb, pb = _batches()
    tree = _flax_tree(seed=1)
    model = JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM)
    applied = {}

    def get(jax_mode):
        if jax_mode not in applied:
            def fn(tree, jb):
                (emb, logits), state = model.apply(
                    tree, jb, method=lambda m, b: (e := m.embed(b), m.out(e)),
                    capture_intermediates=True)
                conv0 = state["intermediates"]["net"]["gnn"]["convs_0"]["__call__"][0]
                return jnp.concatenate([emb, logits, conv0], axis=1)

            out = _run_jax(jax_mode, lambda: jax.jit(fn)(tree, jb))
            cut = [DIMS[-1], DIMS[-1] + LABEL_DIM]
            applied[jax_mode] = np.split(out, cut, axis=1)
        return applied[jax_mode]

    return jb, pb, tree, get


@pytest.mark.parametrize("port_mode,jax_mode", MODES)
def test_sage_conv_matches(port_mode, jax_mode, jax_sage):
    """The port's SAGEConv against JAX's first conv of the model on hop 0
    (its output as the JAX GraphSAGESupervised apply computed it)."""
    _, pb, tree, get = jax_sage
    want = get(jax_mode)[2]
    sub = {"params": tree["params"]["net"]["gnn"]["convs_0"]}
    conv = SAGEConv(FEAT, DIMS[0])
    conv.load_state_dict(from_flax(sub))
    got = _run_port(port_mode, lambda: conv(pb.feats[0], pb.feats[1], pb.blocks[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("port_mode,jax_mode", MODES)
def test_gnn_net_and_graphsage_match(port_mode, jax_mode, jax_sage):
    """One JAX GraphSAGESupervised apply gives the embeddings (its
    GNNNet's output) and the logits; the port's GNNNet and
    GraphSAGESupervised are each held against them."""
    _, pb, tree, get = jax_sage
    want_emb, want_logits, _ = get(jax_mode)

    net = GNNNet(FEAT, "sage", DIMS)
    net.load_state_dict(from_flax({"params": tree["params"]["net"]["gnn"]}))
    sage = GraphSAGESupervised(FEAT, DIMS, LABEL_DIM)
    sage.load_state_dict(from_flax(tree))
    emb_net = _run_port(port_mode, lambda: net(pb))
    emb, logits = _run_port(port_mode, lambda: (e := sage.embed(pb), sage.out(e)))
    for got, ref in ((emb_net, want_emb), (emb, want_emb), (logits, want_logits)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


# bf16 keeps 8 significant bits: unit roundoff 2^-8. Both packages round at
# the same points (inputs, kernel, product, bias add); they differ only
# where an f32 accumulation order moves a rounding by one unit, which the
# second layer and the head can carry a few times over
BF16_TOL = 4 * 2.0**-8


def test_bf16_graphsage_matches_flax():
    """GraphSAGESupervised with bf16 convs against flax's
    conv_kwargs={"dtype": bfloat16} on the same params: bf16 embeddings,
    and the loss and logits (the f32 head over them), within BF16_TOL
    relative (absolute against the largest embedding)."""
    jb, pb = _batches()
    labels = np.eye(LABEL_DIM, dtype=np.float32)[[0, 1, 1, 0, 1]]
    jb = jb.replace(labels=labels)
    pb.labels = torch.from_numpy(labels)
    tree = _flax_tree(seed=2)
    model = JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM, conv_kwargs={"dtype": jnp.bfloat16})
    prev = jax_ops.pallas_mode()
    jax_ops.set_pallas("auto")  # the fused grid path; XLA's form on the CPU
    try:
        jemb, jloss = jax.jit(lambda t, b: model.apply(t, b)[:2])(tree, jb)
    finally:
        jax_ops.set_pallas(prev)
    assert jemb.dtype == jnp.bfloat16
    sage = GraphSAGESupervised(FEAT, DIMS, LABEL_DIM, conv_kwargs={"dtype": torch.bfloat16})
    sage.load_state_dict(from_flax(tree))
    assert all(p.dtype == torch.float32 for p in sage.parameters())
    emb, loss, name, _ = _run_port("ref", lambda: sage(pb))
    assert emb.dtype == torch.bfloat16 and name == "f1"
    want = np.asarray(jemb, np.float32)
    np.testing.assert_allclose(emb.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(want).max())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_TOL)


def test_from_flax_layout():
    sd = from_flax(_flax_tree())
    assert set(sd) == {
        "net.gnn.convs.0.linear.weight", "net.gnn.convs.0.linear.bias",
        "net.gnn.convs.1.linear.weight", "net.gnn.convs.1.linear.bias",
        "out.weight", "out.bias",
    }
    k = _flax_tree()["params"]["net"]["gnn"]["convs_1"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(sd["net.gnn.convs.1.linear.weight"].numpy(), k.T)


def test_degrees_match():
    jb, pb = _batches()
    for jk, pk in zip(jb.blocks, pb.blocks):
        for with_self in (True, False):
            np.testing.assert_array_equal(
                degrees(pk, with_self).numpy(), np.asarray(jax_degrees(jk, with_self))
            )
