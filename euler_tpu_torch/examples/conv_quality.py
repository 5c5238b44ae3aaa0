"""The full-graph quality recipes of the JAX package's tests
(`tests/test_quality.py:82-96`, `:136-170`, `:244-263`, `:306-320`) on the
port: each conv trained for 200 steps (GAT at 640 labels: 300) through
`FullGraphFlow(gcn_norm=True)` on `cora_like`, adam lr 0.01, then micro-F1
on the 1 000 test nodes against the JAX test's band. The split is the
published one: the 140 nodes of type 0 train (`pool="140"`), or the 640 of
types 0 and 1 (`pool="640"`); type 2 is the test set.

A model starts from the params the JAX test's Estimator draws for it
(`params.flax_init` at the recipe's seed, 0 as in the JAX tests), so a
recipe is the JAX test: the same graph, init, steps and split. The F1
moves with the init seed by more than the bands are wide (so it does in
the JAX package), so the band is held at seed 0, the seed the bands were
calibrated at; the F1 of other seeds (`--seeds`) is reported beside it.

    python -m euler_tpu_torch.examples.conv_quality --device cpu [--seeds 0 1 2]

prints one JSON line of every recipe's F1 at each seed and whether the
first seed's lies in its band (on the CUDA card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# (conv, dims, conv_kwargs, train pool, steps, band): the JAX tests' bands
# around the published cora F1s (examples/<name>/README.md)
RECIPES = {
    "gcn": ("gcn", [16, 16], None, "140", 200, (0.79, 0.88)),
    "appnp": ("appnp", [16, 16], None, "140", 200, (0.78, 0.90)),
    "gat": ("gat", [64, 64], {"heads": 4, "improved": True}, "140", 200, (0.70, 0.86)),
    "sgcn": ("sgcn", [16, 16], None, "140", 200, (0.79, 0.92)),
    "tagcn": ("tagcn", [16, 16], None, "140", 200, (0.70, 0.86)),
    "arma": ("arma", [16, 16], None, "140", 200, (0.65, 0.82)),
    "gat_640": ("gat", [64, 64], {"heads": 4, "improved": True}, "640", 300, (0.86, 0.97)),
}
POOLS = {"140": (0,), "640": (0, 1)}


def cora_like():
    """(graph, node types) of the cora stand-in at its full size."""
    from euler_tpu_torch.datasets import cora_like_json
    from euler_tpu_torch.graph import Graph

    j = cora_like_json()
    return Graph.from_json(j), np.asarray([n["type"] for n in j["nodes"]])


def conv_quality(name: str, device=None, data=None, seeds=(0,)) -> dict:
    """One recipe of RECIPES on `data` (`cora_like()`'s pair, built when
    None), trained from the JAX init of each seed of `seeds`: {"f1": the
    first seed's, "in_band": whether it lies in the band, "f1_by_seed",
    ...}. The train and test batches are moved to the device once: the
    whole-graph batch does not change."""
    from euler_tpu_torch.dataflow import FullGraphFlow, to_device
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.nn import SuperviseModel
    from euler_tpu_torch.params import flax_init

    conv, dims, kw, pool, steps, band = RECIPES[name]
    g, types = data if data is not None else cora_like()
    device = resolve_device(device)
    tr = (np.nonzero(np.isin(types, POOLS[pool]))[0] + 1).astype(np.uint64)
    te = (np.nonzero(types == 2)[0] + 1).astype(np.uint64)
    flow = FullGraphFlow(g, ["feature"], "label", num_hops=len(dims), gcn_norm=True)
    train, test = (to_device(flow.query(ids), device) for ids in (tr, te))
    in_dim = g.meta.feature_spec("feature").dim
    f1s, final = [], []
    for seed in seeds:
        model = SuperviseModel(in_dim, conv, dims, 7, conv_kwargs=kw)
        est = Estimator(model, lambda: (train,),
                        EstimatorConfig(learning_rate=0.01, log_steps=10**9, seed=seed),
                        init_params=flax_init(model, seed), device=device)
        final.append(est.train(steps, log=False, save=False)[-1])
        f1s.append(est.evaluate([(test,)])["f1"])
    return {"conv": conv, "dims": dims, "conv_kwargs": kw, "train_labels": len(tr),
            "steps": steps, "seeds": list(seeds), "final_loss_by_seed": final,
            "f1_by_seed": f1s, "f1": f1s[0], "band": band, "in_band": band[0] < f1s[0] < band[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run on the CPU")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="init seeds; the band is held at the first")
    args = ap.parse_args(argv)
    from euler_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    data = cora_like()
    out = {name: conv_quality(name, device, data, args.seeds) for name in RECIPES}
    print(json.dumps({**out, "device": str(device), "torch_threads": torch.get_num_threads(),
                      "cores": os.cpu_count()}))
    return 0 if all(r["in_band"] for r in out.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
