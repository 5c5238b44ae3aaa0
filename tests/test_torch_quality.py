"""The port's full-graph quality recipes (`examples/conv_quality.py`)
against the JAX package's (`tests/test_quality.py:82-96`): the same
cora stand-in, steps and split, the port starting from `params.flax_init`
at seed 0, the JAX Estimator from its own init: the same F1.

Second tier, as tests/test_quality.py: `pytest -m quality
--override-ini addopts=` (minutes on the CPU).
"""

import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FullGraphFlow as JaxFullGraphFlow
from euler_tpu.datasets.quality import cora_like_json as jax_cora_like_json
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.nn import SuperviseModel as JaxSuperviseModel
from euler_tpu_torch.examples.conv_quality import POOLS, RECIPES, conv_quality, cora_like

pytestmark = [pytest.mark.quality, pytest.mark.slow]

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def data():
    return cora_like(), JaxGraph.from_json(jax_cora_like_json())


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_gives_the_jax_f1(name, data, tmp_path):
    (g, types), jg = data
    conv, dims, kw, pool, steps, band = RECIPES[name]
    tr = (np.nonzero(np.isin(types, POOLS[pool]))[0] + 1).astype(np.uint64)
    te = (np.nonzero(types == 2)[0] + 1).astype(np.uint64)
    jf = JaxFullGraphFlow(jg, ["feature"], "label", num_hops=len(dims), gcn_norm=True)
    jest = JaxEstimator(JaxSuperviseModel(conv=conv, dims=dims, label_dim=7, conv_kwargs=kw),
                        lambda: (jf.query(tr),),
                        JaxConfig(model_dir=str(tmp_path), learning_rate=0.01, log_steps=10**9))
    jest.train(total_steps=steps, save=False, log=False)
    want = jest.evaluate([(jf.query(te),)])["f1"]
    got = conv_quality(name, "cpu", (g, types))
    assert band[0] < want < band[1]
    assert abs(got["f1"] - want) <= 0.005, (got["f1"], want)
