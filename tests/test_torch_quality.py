"""The port's conv quality recipes (`examples/conv_quality.py`) against
the JAX package's (`tests/test_quality.py:82-96`, `:871-908`): the same
cora stand-in, steps, learning rate and split (LGCN: the same sampled
flow and draws), the port starting from `params.flax_init` at seed 0,
the JAX Estimator from its own init: the same F1. Likewise the
layer-wise recipes (FastGCN, AdaptiveGCN; `:817-862`) and GAE's AUC
(`examples/link_quality.py`, `:909-947`).

Second tier, as tests/test_quality.py: `pytest -m quality
--override-ini addopts=` (minutes on the CPU).
"""

import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FullGraphFlow as JaxFullGraphFlow
from euler_tpu.dataflow import SageDataFlow as JaxSageDataFlow
from euler_tpu.datasets.quality import cora_like_json as jax_cora_like_json
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.nn import SuperviseModel as JaxSuperviseModel
from euler_tpu_torch.examples.conv_quality import (
    POOLS,
    RECIPES,
    SAMPLED_BATCH,
    SAMPLED_EVAL,
    SAMPLED_FANOUTS,
    conv_quality,
    cora_like,
)

pytestmark = [pytest.mark.quality, pytest.mark.slow]

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def data():
    return cora_like(), JaxGraph.from_json(jax_cora_like_json())


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_gives_the_jax_f1(name, data, tmp_path):
    (g, types), jg = data
    r = RECIPES[name]
    tr = (np.nonzero(np.isin(types, POOLS[r.pool]))[0] + 1).astype(np.uint64)
    te = (np.nonzero(types == 2)[0] + 1).astype(np.uint64)
    model = JaxSuperviseModel(conv=r.conv, dims=r.dims, label_dim=7, conv_kwargs=r.kw)
    cfg = JaxConfig(model_dir=str(tmp_path), learning_rate=r.lr, log_steps=10**9)
    if r.flow == "sampled":
        rng = np.random.default_rng(0)
        jf = JaxSageDataFlow(jg, ["feature"], fanouts=SAMPLED_FANOUTS, label_feature="label",
                             rng=rng)
        jest = JaxEstimator(model, lambda: (jf.query(rng.choice(tr, SAMPLED_BATCH)),), cfg)
        jest.train(total_steps=r.steps, save=False, log=False)
        want = jest.evaluate([(jf.query(te[i : i + SAMPLED_EVAL]),)
                              for i in range(0, 1000, SAMPLED_EVAL)])["f1"]
    else:
        jf = JaxFullGraphFlow(jg, ["feature"], "label", num_hops=len(r.dims), gcn_norm=True)
        jest = JaxEstimator(model, lambda: (jf.query(tr),), cfg)
        jest.train(total_steps=r.steps, save=False, log=False)
        want = jest.evaluate([(jf.query(te),)])["f1"]
    got = conv_quality(name, "cpu", (g, types))
    assert r.band[0] < want < r.band[1]
    assert abs(got["f1"] - want) <= 0.005, (got["f1"], want)


@pytest.fixture(scope="module")
def mutag():
    from euler_tpu.datasets.quality import mutag_like_json as jax_mutag_like_json
    from euler_tpu_torch.examples.graph_clf_quality import mutag_like

    return mutag_like(), JaxGraph.from_json(jax_mutag_like_json())


@pytest.mark.parametrize("name", ["gin", "set2set", "gated_graph", "graphgcn"])
def test_graph_clf_recipe_gives_the_jax_accuracy(name, mutag, tmp_path):
    """`examples/graph_clf_quality.py` against the JAX test's
    `_mutag_clf_acc`: both in the band, and at most one of the 32 test
    graphs classified otherwise (300 adam steps on batches of 16 amplify
    the f32 summation order: the losses agree within 2e-5 for ~20 steps,
    then drift)."""
    from euler_tpu.dataflow import WholeGraphDataFlow as JaxWholeGraphDataFlow
    from euler_tpu.models import GraphClassifier as JaxGraphClassifier
    from euler_tpu_torch.examples import graph_clf_quality as q

    g, jg = mutag
    conv, pool, band = q.RECIPES[name]
    rng = np.random.default_rng(0)
    n = len(jg.meta.graph_labels)
    perm = rng.permutation(n)
    tr, te = perm[: int(0.8 * n)], perm[int(0.8 * n):]
    jf = JaxWholeGraphDataFlow(jg, ["feature"], max_nodes=q.MAX_NODES, max_degree=q.MAX_DEGREE)
    jest = JaxEstimator(JaxGraphClassifier(conv=conv, dims=list(q.DIMS), num_classes=2, pool=pool),
                        lambda: (jf.query(rng.choice(tr, size=q.BATCH, replace=False)),),
                        JaxConfig(model_dir=str(tmp_path), learning_rate=q.LR, log_steps=10**9))
    jest.train(total_steps=q.STEPS, save=False, log=False)
    want = jest.evaluate([(jf.query(te[i : i + q.BATCH]),)
                          for i in range(0, len(te) - q.BATCH + 1, q.BATCH)])["acc"]
    got = q.graph_clf_quality(name, "cpu", g)
    assert band[0] < want <= band[1] and got["in_band"], (want, got["acc"])
    assert abs(got["acc"] - want) <= 1 / 32 + 1e-9, (got["acc"], want)


@pytest.mark.parametrize("name", ["fastgcn", "adaptivegcn"])
def test_layerwise_recipe_gives_the_jax_f1(name, data, tmp_path):
    """`conv_quality.layerwise_quality` against the JAX test's
    `test_layerwise_cora_f1` (the same flow, draws, steps and split; the
    port from `params.flax_init` at seed 0): within 0.005."""
    from euler_tpu.dataflow import LayerwiseDataFlow as JaxLayerwiseDataFlow
    from euler_tpu.models import LayerwiseGCN as JaxLayerwiseGCN
    from euler_tpu_torch.examples.conv_quality import (LAYERWISE_DIMS, LAYERWISE_EVAL,
                                                       LAYERWISE_LR, LAYERWISE_RECIPES,
                                                       layerwise_quality)

    (g, types), jg = data
    r = LAYERWISE_RECIPES[name]
    tr = (np.nonzero(np.isin(types, POOLS["640"]))[0] + 1).astype(np.uint64)
    te = (np.nonzero(types == 2)[0] + 1).astype(np.uint64)
    rng = np.random.default_rng(0)
    jf = JaxLayerwiseDataFlow(jg, ["feature"], layer_sizes=list(r.layer_sizes),
                              label_feature="label", rng=rng)
    jest = JaxEstimator(JaxLayerwiseGCN(dims=LAYERWISE_DIMS, label_dim=7),
                        lambda: (jf.query(rng.choice(tr, size=r.batch, replace=True)),),
                        JaxConfig(model_dir=str(tmp_path), learning_rate=LAYERWISE_LR,
                                  log_steps=10**9))
    jest.train(total_steps=r.steps, save=False, log=False)
    want = jest.evaluate([(jf.query(te[i : i + LAYERWISE_EVAL]),)
                          for i in range(0, 1000, LAYERWISE_EVAL)])["f1"]
    got = layerwise_quality(name, "cpu", (g, types))
    assert r.band[0] < want < r.band[1] and got["in_band"], (want, got["f1"])
    assert abs(got["f1"] - want) <= 0.005, (got["f1"], want)


def test_gae_recipe_gives_the_jax_auc(data, tmp_path):
    """`link_quality.gae_quality("gae")` against the JAX test's
    `test_gae_vgae_cora_like[False]`: within 0.005. (VGAE draws its noise
    from the port's generators, so only its band is held, by
    `chip_smoke.py` and the recipe's own exit code.)"""
    from euler_tpu.models import GAE as JaxGAE
    from euler_tpu.models import gae_batches as jax_gae_batches
    from euler_tpu_torch.examples import link_quality as lq

    (g, _), jg = data
    rng = np.random.default_rng(0)
    jf = JaxSageDataFlow(jg, ["feature"], fanouts=[10], rng=rng)
    jest = JaxEstimator(JaxGAE(dims=[32]), jax_gae_batches(jg, jf, lq.GAE_BATCH, rng=rng),
                        JaxConfig(model_dir=str(tmp_path), learning_rate=0.01, log_steps=10**9))
    jest.train(total_steps=lq.GAE_STEPS, save=False, log=False)
    want = jest.evaluate([jax_gae_batches(jg, jf, lq.GAE_EVAL_BATCH,
                                          rng=np.random.default_rng(7))()
                          for _ in range(lq.GAE_EVALS)])["auc"]
    got = lq.gae_quality("gae", "cpu", g)
    band = lq.GAE_BANDS["gae"]
    assert band[0] < want < band[1] and got["in_band"], (want, got["auc"])
    assert abs(got["auc"] - want) <= 0.005, (got["auc"], want)
