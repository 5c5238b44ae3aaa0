"""Durable trainer CLI (counterpart: euler_tpu/tools/train.py:47-272).

Trains supervised GraphSAGE over a local graph dir under a
`TrainingSession` (atomic retained checkpoints, async save, SIGTERM
drain, anomaly guard, watchdog), on the CUDA card unless `--device cpu`:

    python -m euler_tpu_torch.tools.train --data DIR --model-dir CKPT \
        --total-steps 200 --checkpoint-every 20 [--resume] [--device cpu]

`--resume` restores the newest complete retained checkpoint — params,
optimizer state, step and the batch-source cursor — so a respawn after
`kill -9` continues the run bitwise. Exit codes: 0 = target step
reached, 3 = preempted (SIGTERM drain flushed a final checkpoint first),
anything else = crash. The last line of stdout is a JSON report.
`--losses-out FILE` appends one JSON line of per-step losses per run
segment. `--native` serves the graph's hot paths from the C++ engine
(`Graph.load(native=None)`: used when a host compiler builds it).

Not ported yet: `--cluster` / `--registry` (the distributed client) and
`--mutate-spec` (`graph/delta.py`); each exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_trainer(args, graph=None):
    """(session, est, source, graph) for the CLI args — importable, so a
    test builds the same trainer in process."""
    from euler_tpu_torch.dataflow import FullNeighborDataFlow
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.training import (
        SessionConfig,
        TrainingSession,
        resumable_node_batches,
    )

    if graph is None:
        graph = Graph.load(args.data, native=None if args.native else False)
    dims = [int(x) for x in args.dims.split(",")]
    features = args.features.split(",") if args.features else []
    # full-neighbor flow: deterministic per root set, so the batch stream
    # is a pure function of (source seed, cursor)
    flow = FullNeighborDataFlow(
        graph,
        features,
        num_hops=len(dims),
        max_degree=args.max_degree,
        label_feature=args.label_feature,
    )
    source = resumable_node_batches(graph, flow, args.batch_size, seed=args.source_seed)
    in_dim = sum(graph.meta.feature_spec(f).dim for f in features)
    model = GraphSAGESupervised(
        in_dim=in_dim, dims=dims, label_dim=args.label_dim, conv=args.conv
    )
    est = Estimator(
        model,
        source,
        EstimatorConfig(
            model_dir=args.model_dir,
            total_steps=args.total_steps,
            log_steps=args.log_steps,
            learning_rate=args.learning_rate,
            seed=args.seed,
            keep_checkpoints=args.keep,
        ),
        device=args.device,
    )
    session = TrainingSession(
        est,
        source=source,
        graph=graph,
        cfg=SessionConfig(
            checkpoint_every=args.checkpoint_every,
            keep=args.keep,
            async_save=not args.sync_save,
            anomaly_policy=args.anomaly_policy,
            max_strikes=args.max_strikes,
            step_deadline_s=args.step_deadline_s,
        ),
    )
    return session, est, source, graph


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", help="local graph directory (Graph.load)")
    ap.add_argument("--cluster", default=None, help="not ported yet")
    ap.add_argument("--registry", default=None, help="not ported yet")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--total-steps", type=int, default=100)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--dims", default="8,8")
    ap.add_argument("--features", default="feat")
    ap.add_argument("--label-feature", default="label")
    ap.add_argument("--label-dim", type=int, default=2)
    ap.add_argument("--conv", default="sage")
    ap.add_argument("--max-degree", type=int, default=4)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--log-steps", type=int, default=10**9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source-seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest complete retained checkpoint")
    ap.add_argument("--sync-save", action="store_true",
                    help="inline checkpoint writes (A/B the async writer)")
    ap.add_argument("--anomaly-policy", default="skip",
                    choices=("off", "skip", "rollback", "abort"))
    ap.add_argument("--max-strikes", type=int, default=3)
    ap.add_argument("--step-deadline-s", type=float, default=0.0)
    ap.add_argument("--mutate-spec", default=None, help="not ported yet")
    ap.add_argument("--losses-out", default=None,
                    help="append one JSON line of per-step losses per segment")
    ap.add_argument("--native", action="store_true",
                    help="sample through the C++ graph engine")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (an error without one)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, value in (("--cluster", args.cluster), ("--registry", args.registry),
                        ("--mutate-spec", args.mutate_spec)):
        if value:
            ap.error(f"{flag} is not ported yet")
    if not args.data:
        ap.error("--data is required")

    session, est, source, graph = build_trainer(args)
    resume_report = session.restore() if args.resume else None

    segments = []
    remaining = args.total_steps - est.step
    if remaining > 0:
        segments.append(session.run(remaining))
    preempted = bool(segments) and segments[-1]["preempted"]

    if args.losses_out and segments:
        with open(args.losses_out, "a", encoding="utf-8") as f:
            for rep in segments:
                f.write(json.dumps({
                    "start_step": rep["start_step"],
                    "loss_steps": rep["loss_steps"],
                    "losses": rep["losses"],
                    "resumed_from": rep["resumed_from"],
                }) + "\n")
            f.flush()
            os.fsync(f.fileno())

    done = est.step >= args.total_steps
    print(json.dumps({
        "done": done,
        "preempted": preempted,
        "step": int(est.step),
        "resumed": resume_report,
        "telemetry": segments[-1]["telemetry"] if segments else None,
    }), flush=True)
    return 0 if done else 3


if __name__ == "__main__":
    sys.exit(main())
