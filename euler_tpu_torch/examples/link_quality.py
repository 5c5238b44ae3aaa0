"""The link-prediction quality recipes of the JAX package's tests
(`tests/test_quality.py:467-546`, `:909-947`) on the port: LINE and
DeepWalk edge-ranking MRR on `cora_like`, TransE MeanRank / Hit@10 on
`fb15k_like` with the untrained control, GAE and VGAE held-out
link-prediction AUC on `cora_like`, each with the JAX test's steps,
learning rate, batch and seeds, and its band. GAE and VGAE start from
the params the JAX test's Estimator draws (`params.flax_init`, seed 0)
and consume its init draw; VGAE's noise comes from the port's
generators, so its AUC is the band's, not the JAX test's number.

    python -m euler_tpu_torch.examples.link_quality --device cpu

prints one JSON line of the metrics and whether each lies in its band
(on the CUDA card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

# (steps, band) of each recipe: the JAX tests' bands around the published
# cora MRRs (examples/{line,deepwalk}/README.md) and FB15k numbers
LINE_STEPS, LINE_BAND = 2000, (0.87, 0.97)
DEEPWALK_STEPS, DEEPWALK_BAND = 600, (0.87, 0.995)
TRANSE_STEPS, TRANSE_CONTROL_MR = 1500, 600
TRANSE_MR_BAND, TRANSE_HIT_BAND = (30, 420), (0.32, 0.55)
# GAE / VGAE (tests/test_quality.py:909-947): around the published cora
# AUCs 0.71 / 0.79 (examples/gae/README.md)
GAE_STEPS, GAE_BATCH, GAE_EVAL_BATCH, GAE_EVALS = 400, 128, 256, 4
GAE_BANDS = {"gae": (0.74, 0.92), "vgae": (0.70, 0.90)}


def _estimator(model, batch_fn, lr: float, device):
    """An Estimator that trains without saving (nothing is written)."""
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig

    return Estimator(model, batch_fn, EstimatorConfig(learning_rate=lr, log_steps=10**9),
                     device=device)


def edge_mrr(g, model, num_negs: int = 20) -> float:
    """Held-out edge-ranking MRR (tests/test_quality.py:111-133): each of
    2 000 sampled edges' dst scored against num_negs sampled nodes."""
    rng = np.random.default_rng(123)
    e = g.sample_edge(2000, rng=rng)
    dev = next(model.parameters()).device

    def ids(a):
        return torch.as_tensor(a.astype(np.int64).astype(np.int32), device=dev)

    negs = g.sample_node(2000 * num_negs, rng=rng)
    with torch.inference_mode():
        emb = model.embed(ids(e[:, 0]))
        pos = torch.sum(emb * model._ctx(ids(e[:, 1])), dim=1)
        neg = torch.einsum("bd,bnd->bn", emb, model._ctx(ids(negs)).reshape(2000, num_negs, -1))
        ranks = 1 + torch.sum((neg > pos[:, None]).int(), dim=1)
    return float(torch.mean(1.0 / ranks.float()))


def skipgram_quality(name: str, device=None, graph=None) -> dict:
    """LINE (first order, one shared table) or DeepWalk (walk 3, window 1)
    on cora_like: dim 32, 20 negatives, batch 128, lr 0.05."""
    from euler_tpu_torch.datasets import cora_like_json
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import SkipGramModel, deepwalk_batches, line_batches

    g = graph if graph is not None else Graph.from_json(cora_like_json())
    rng = np.random.default_rng(0)
    if name == "line":
        src, steps, band = line_batches(g, 128, num_negs=20, rng=rng), LINE_STEPS, LINE_BAND
    else:
        src = deepwalk_batches(g, 128, walk_len=3, window=1, num_negs=20, rng=rng)
        steps, band = DEEPWALK_STEPS, DEEPWALK_BAND
    est = _estimator(SkipGramModel(num_nodes=2709, dim=32, shared_context=name == "line"), src,
                     0.05, device)
    est.train(steps, log=False, save=False)
    mrr = edge_mrr(g, est.model)
    return {"steps": steps, "mrr": mrr, "band": band, "in_band": band[0] < mrr < band[1]}


def transe_quality(device=None) -> dict:
    """TransE on fb15k_like: dim 32, 8 negatives, batch 512, lr 0.05; the
    control after 1 step, the metrics after 1 500 more."""
    from euler_tpu_torch.datasets import fb15k_like
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import TransX, kg_batches, kg_rank_eval

    j, test = fb15k_like()
    g = Graph.from_json(j)
    est = _estimator(TransX(num_entities=2001, num_relations=40, dim=32, variant="transe"),
                     kg_batches(g, 512, num_negs=8, rng=np.random.default_rng(0)), 0.05, device)
    est.train(1, log=False, save=False)
    r0 = kg_rank_eval(est.model, None, test[:500], num_entities=2000)
    est.train(TRANSE_STEPS, log=False, save=False)
    r1 = kg_rank_eval(est.model, None, test[:500], num_entities=2000)
    ok = (r0["mean_rank"] > TRANSE_CONTROL_MR
          and TRANSE_MR_BAND[0] < r1["mean_rank"] < TRANSE_MR_BAND[1]
          and TRANSE_HIT_BAND[0] < r1["hit@10"] < TRANSE_HIT_BAND[1])
    return {"steps": TRANSE_STEPS, "control": r0, "trained": r1,
            "mean_rank_band": TRANSE_MR_BAND, "hit10_band": TRANSE_HIT_BAND, "in_band": ok}


def gae_quality(name: str, device=None, graph=None, seed: int = 0) -> dict:
    """GAE or VGAE ("gae" / "vgae") on cora_like: dims [32] over
    SageDataFlow(fanouts [10]), gae_batches of 128 edges, adam lr 0.01,
    GAE_STEPS steps, then the AUC over GAE_EVALS held-out batches of 256
    (each a fresh default_rng(7) source over the trained flow)."""
    from euler_tpu_torch.dataflow import SageDataFlow
    from euler_tpu_torch.datasets import cora_like_json
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GAE, gae_batches
    from euler_tpu_torch.params import flax_init

    g = graph if graph is not None else Graph.from_json(cora_like_json())
    rng = np.random.default_rng(0)
    flow = SageDataFlow(g, ["feature"], fanouts=[10], rng=rng)
    model = GAE(g.meta.feature_spec("feature").dim, [32], variational=name == "vgae")
    batch_fn = gae_batches(g, flow, GAE_BATCH, rng=rng)
    est = Estimator(model, batch_fn,
                    EstimatorConfig(learning_rate=0.01, log_steps=10**9, seed=seed),
                    init_params=flax_init(model, seed), device=device)
    batch_fn()  # the draw the JAX Estimator initialises from
    final = est.train(GAE_STEPS, log=False, save=False)[-1]
    evals = [gae_batches(g, flow, GAE_EVAL_BATCH, rng=np.random.default_rng(7))()
             for _ in range(GAE_EVALS)]
    auc = est.evaluate(evals)["auc"]
    band = GAE_BANDS[name]
    return {"steps": GAE_STEPS, "final_loss": final, "auc": auc, "band": band,
            "in_band": band[0] < auc < band[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    from euler_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out = {"line": skipgram_quality("line", device),
           "deepwalk": skipgram_quality("deepwalk", device),
           "transe": transe_quality(device), "gae": gae_quality("gae", device),
           "vgae": gae_quality("vgae", device), "device": str(device),
           "torch_threads": torch.get_num_threads(), "cores": os.cpu_count()}
    print(json.dumps(out))
    return 0 if all(out[k]["in_band"]
                    for k in ("line", "deepwalk", "transe", "gae", "vgae")) else 1


if __name__ == "__main__":
    raise SystemExit(main())
