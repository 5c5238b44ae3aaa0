"""Model-serving setup (counterpart: euler_tpu/tools/serve.py:39-78).

`build_runtime(args)` loads a graph dir and a checkpoint written by the
JAX `Estimator.save` and returns an InferenceRuntime for a
supervised GraphSAGE model, on the CUDA card unless device="cpu". The
flags keep the JAX CLI's names:

    --data DIR --model-dir CKPT --features feat --dims 128,128
    --label-dim 2 --fanouts 10,10 --buckets 8,32,128 --seed 0 [--native]

`--native` samples through the C++ graph engine (`Graph.load(native=None)`).

The TCP front end (ModelServer, batcher, client) is not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True, help="graph directory (Graph.load)")
    ap.add_argument("--model-dir", default=None,
                    help="checkpoint dir (ckpt_<step>/ written by Estimator.save)")
    ap.add_argument("--features", default="feat")
    ap.add_argument("--dims", default="128,128")
    ap.add_argument("--label-dim", type=int, default=2)
    ap.add_argument("--fanouts", default="10,10")
    ap.add_argument("--buckets", default="8,32,128",
                    help="padded batch-size buckets, comma-separated")
    ap.add_argument("--seed", type=int, default=0, help="sampling seed of the flow")
    ap.add_argument("--native", action="store_true",
                    help="sample through the C++ graph engine")
    return ap


def build_runtime(args, graph=None, device=None, params=None):
    """InferenceRuntime over `args.data` (or an already loaded `graph`)
    with the checkpoint under `args.model_dir`, or with `params` (a port
    state_dict) when given."""
    from euler_tpu_torch.dataflow import SageDataFlow
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import InferenceRuntime

    if graph is None:
        graph = Graph.load(args.data, native=None if args.native else False)
    features = args.features.split(",") if args.features else []
    dims = [int(x) for x in args.dims.split(",")]
    flow = SageDataFlow(
        graph,
        features,
        fanouts=[int(x) for x in args.fanouts.split(",")],
        rng=np.random.default_rng(args.seed),
    )
    in_dim = sum(graph.meta.feature_spec(f).dim for f in features)
    model = GraphSAGESupervised(in_dim=in_dim, dims=dims, label_dim=args.label_dim)
    return InferenceRuntime(
        model,
        flow,
        args.model_dir,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        params=params,
        device=device,
    )
