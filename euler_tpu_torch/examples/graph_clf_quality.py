"""The graph-classification quality recipes of the JAX package's tests
(`tests/test_quality.py:556-660`) on the port: a GraphClassifier (dims
32, 32) over `WholeGraphDataFlow(max_nodes=24, max_degree=12)` on the
mutag stand-in (`mutag_like_json`: 188 graphs whose classes differ only
in which node labels share an edge), trained 300 adam steps at lr 0.01 on
batches of 16 graphs drawn without replacement from the 80 % train split
(`default_rng(0)`'s permutation; the same generator draws the batches),
then accuracy on the held-out 20 % in batches of 16 against the JAX
test's band.

A model starts from the params the JAX test's Estimator draws for it
(`params.flax_init` at seed 0), and the first batch draw is the one the
JAX Estimator initialises from, so a recipe is the JAX test.

    python -m euler_tpu_torch.examples.graph_clf_quality --device cpu

prints one JSON line of every recipe's accuracy and whether it lies in
its band (on the CUDA card unless `--device cpu`); exits 1 when one does
not.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# name -> (conv, pool, band): accuracy in (lo, hi]; the JAX tests' bands
# around the published mutag accuracies (examples/<name>/README.md)
RECIPES = {
    "gin": ("gin", "add", (0.85, 1.0)),
    "set2set": ("gin", "set2set", (0.85, 0.97)),
    "gated_graph": ("gated", "mean", (0.82, 0.95)),
    "graphgcn": ("gcn", "attention", (0.85, 0.97)),
}
DIMS, STEPS, LR, BATCH = (32, 32), 300, 0.01, 16
MAX_NODES, MAX_DEGREE = 24, 12


def mutag_like():
    from euler_tpu_torch.datasets import mutag_like_json
    from euler_tpu_torch.graph import Graph

    return Graph.from_json(mutag_like_json())


def graph_clf_quality(name: str, device=None, graph=None, seed: int = 0) -> dict:
    """One recipe of RECIPES on `graph` (`mutag_like()`, built when None)
    from the JAX init of `seed`: {"acc", "band", "in_band", ...}."""
    from euler_tpu_torch.dataflow import WholeGraphDataFlow
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphClassifier
    from euler_tpu_torch.params import flax_init

    conv, pool, band = RECIPES[name]
    g = graph if graph is not None else mutag_like()
    device = resolve_device(device)
    n = len(g.meta.graph_labels)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    tr, te = perm[: int(0.8 * n)], perm[int(0.8 * n):]
    flow = WholeGraphDataFlow(g, ["feature"], max_nodes=MAX_NODES, max_degree=MAX_DEGREE)
    if flow.num_classes != 2:
        raise ValueError(f"expected 2 classes from the `_c<k>` labels, got {flow.num_classes}")

    def batch_fn():
        return (flow.query(rng.choice(tr, size=BATCH, replace=False)),)

    model = GraphClassifier(g.meta.feature_spec("feature").dim, conv, DIMS, 2, pool)
    est = Estimator(model, batch_fn, EstimatorConfig(learning_rate=LR, log_steps=10**9,
                                                     seed=seed),
                    init_params=flax_init(model, seed), device=device)
    batch_fn()  # the JAX Estimator's init draw
    losses = est.train(STEPS, log=False, save=False)
    evals = [(flow.query(te[i : i + BATCH]),) for i in range(0, len(te) - BATCH + 1, BATCH)]
    acc = est.evaluate(evals)["acc"]
    return {"conv": conv, "pool": pool, "dims": list(DIMS), "steps": STEPS, "seed": seed,
            "train_graphs": len(tr), "test_graphs": BATCH * len(evals),
            "final_loss": losses[-1], "acc": acc, "band": band,
            "in_band": band[0] < acc <= band[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run on the CPU")
    ap.add_argument("--seed", type=int, default=0, help="init seed; the bands hold at 0")
    args = ap.parse_args(argv)
    from euler_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    g = mutag_like()
    out = {name: graph_clf_quality(name, device, g, args.seed) for name in RECIPES}
    print(json.dumps({**out, "device": str(device), "torch_threads": torch.get_num_threads(),
                      "cores": os.cpu_count()}))
    return 0 if all(r["in_band"] for r in out.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
