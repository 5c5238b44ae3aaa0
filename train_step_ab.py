#!/usr/bin/env python3
"""Train-step timing of the port's paged device lane, for one or more
checkouts of the repository, each in a process of its own, in the order
given (e.g. parent, change, change, parent):

    python3 train_step_ab.py --tree PARENT_DIR --tree . --tree . --tree PARENT_DIR

Each process imports `euler_tpu_torch` from its tree (building that tree's
kernels into its own `euler_tpu_torch/_build/`), stages the training cell
of `chip_smoke.py` (skewed_weighted_graph with 200 000 nodes, seed 13,
bf16 weight plane, DeviceSageFlow fanouts 10,10, batch 1024, page size 16,
GraphSAGE dims 128,128, adam lr 0.01), trains 20 steps in kernel mode
'auto', then prints `chip_smoke.time_train_steps`'s JSON line (median step
on the host clock, device ms and idle share over 10 profiled steps, kernel
launches a step) with the tree and the kernel launches a step the port
counted. Needs one CUDA card; `chip_smoke.py` of this script's directory
supplies the constants and the timing code. The last line is a JSON
summary of all runs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree: str, seed: int) -> dict:
    """The timing of one tree, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    cs = _chip_smoke()
    import torch

    import euler_tpu_torch
    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import DeviceSageFlow
    from euler_tpu_torch.datasets import skewed_weighted_graph
    from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised

    if not os.path.abspath(euler_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"euler_tpu_torch came from {euler_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("train_step_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["EULER_TPU_PAGE_DTYPE"] = "bf16"
    g = skewed_weighted_graph(cs.TRAIN_NODES, cs.TRAIN_GRAPH_SEED)
    flow = DeviceSageFlow(g, fanouts=cs.TRAIN_FANOUTS, batch_size=cs.TRAIN_BATCH,
                          label_feature="label", layout="paged", page_size=cs.PAGE_SIZE,
                          device="cuda")
    cache = DeviceFeatureCache(g, ["feat"], device="cuda")
    with tempfile.TemporaryDirectory(prefix="euler_ab_") as tmp:
        cfg = EstimatorConfig(model_dir=tmp, learning_rate=0.01, optimizer="adam",
                              log_steps=10**9, seed=seed)
        est = Estimator(GraphSAGESupervised(cs.TRAIN_FEAT, cs.TRAIN_DIMS, 2), flow, cfg,
                        feature_cache=cache, device="cuda")
        ops.reset_launch_counts()
        est.train(cs.TRAIN_STEPS, log=False, save=False)
        torch.cuda.synchronize()
        counted = {k: v / cs.TRAIN_STEPS for k, v in ops.launch_counts().items() if v}
        res = cs.time_train_steps(torch, est, cs._card_line())
    return {"tree": tree, "port_launches_per_step": counted,
            **{k: res[k] for k in ("median_step_ms", "min_step_ms", "max_step_ms",
                                   "device_ms_per_step", "device_idle_share",
                                   "kernel_launches_per_step", "copies_per_step")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout to time (repeat, in the order to run them)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps({"phase": "train_step_ab", **one(args.tree[0], args.seed)}),
              flush=True)
        return 0
    runs = []
    for i, tree in enumerate(args.tree):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--tree", tree, "--seed", str(args.seed)],
                             capture_output=True, text=True, check=False)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            raise RuntimeError(f"run {i} ({tree}) exited {out.returncode}")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"train_step_ab": [{"run": i, **r} for i, r in enumerate(runs)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
