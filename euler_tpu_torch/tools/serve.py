"""Model-serving CLI (counterpart: euler_tpu/tools/serve.py).

Boots one ModelServer — or a replicated fleet — over a graph dir and a
checkpoint written by either package's `Estimator.save`, on the CUDA
card unless `--device cpu`:

    python -m euler_tpu_torch.tools.serve --data DIR --model-dir CKPT \
        --dims 128,128 --label-dim 2 --port 9200 --replicas 4

The flags keep the JAX CLI's names. Graph queries run in process against
the local shard files (`--native` samples through the C++ graph engine).
`--full-neighbor` serves over the deterministic FullNeighborDataFlow
(`--max-degree`), whose rows replay bit for bit; otherwise SageDataFlow
(`--fanouts`, `--seed`). `--conv` names any conv of `layers.CONVS`, as
the port's trainer (`tools/train.py --conv`) does. With
`--registry REG` (a shared dir or tcp://host:port) the servers heartbeat
into a membership registry. `--replicas N` boots N servers (consecutive
ports when --port is pinned, ephemeral otherwise), each with its own
runtime + batcher, on one device — clients front them with a
ServingRouter (`ServingClient(addrs, routing="consistent_hash")`).
`--hedge MS` is the fleet's recommended hedge delay, printed with the
topology. `--reload` watches the checkpoint path and hot-swaps every
replica — zero downtime — when a new complete checkpoint lands.

`--selftest` is the smoke mode: the JAX selftest's 48-node graph, a
2-step checkpoint from the port's Estimator in a temp dir, server(s) +
concurrent clients in process, served rows bitwise equal to
`Estimator.infer`; with `--replicas N` also routed parity, per-replica
fleet stats and hot-reload canary parity. It prints a JSON summary and
exits 0 on success. The JAX selftest's durability probe needs the graph
tier (GraphService, the WAL, replication: ROADMAP queue 1 item 8), so
the summary says `"durability": "not ported"` and `--replication` above
1 raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading

import numpy as np

_NOT_PORTED_REPLICATION = (
    "--replication > 1 needs the graph tier's replica groups, which are not "
    "ported (ROADMAP queue 1 item 8)"
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--selftest", action="store_true",
                    help="in-process server+client smoke; exit 0 on parity")
    ap.add_argument("--data", help="graph directory (Graph.load)")
    ap.add_argument("--model-dir", default=None,
                    help="checkpoint dir (ckpt_<step>/ written by Estimator.save)")
    ap.add_argument("--features", default="feat")
    ap.add_argument("--label-feature", default=None)
    ap.add_argument("--dims", default="128,128")
    ap.add_argument("--label-dim", type=int, default=2)
    ap.add_argument("--conv", default="sage")
    ap.add_argument("--fanouts", default="10,10")
    ap.add_argument("--full-neighbor", action="store_true",
                    help="deterministic full-neighbor flow (replayable)")
    ap.add_argument("--max-degree", type=int, default=32)
    ap.add_argument("--buckets", default="8,32,128",
                    help="padded batch-size buckets, comma-separated")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-us", type=int, default=2000)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--registry", default=None)
    ap.add_argument("--replica", type=int, default=0,
                    help="shard index of the FIRST replica (registry key)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="number of ModelServer replicas to boot")
    ap.add_argument("--replication", type=int, default=1, metavar="R",
                    help="graph-shard replica-group size of the selftest's "
                         "durability probe (only 1: not ported)")
    ap.add_argument("--hedge", type=float, default=None, metavar="MS",
                    help="recommended client hedge delay for this fleet "
                         "(ms; default p95-tracked, EULER_TPU_HEDGE_MS)")
    ap.add_argument("--reload", action="store_true",
                    help="watch --model-dir and hot-swap every replica "
                         "when a new checkpoint lands (zero downtime)")
    ap.add_argument("--native", action="store_true",
                    help="sample through the C++ graph engine")
    ap.add_argument("--seed", type=int, default=0, help="sampling seed of the flow")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    return ap


def build_runtime(args, graph=None, device=None, params=None):
    """InferenceRuntime over `args.data` (or an already loaded `graph`)
    with the checkpoint under `args.model_dir`, or with `params` (a port
    state_dict) when given, on `device` (default `args.device`)."""
    from euler_tpu_torch.dataflow import FullNeighborDataFlow, SageDataFlow
    from euler_tpu_torch.estimator import EstimatorConfig
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import InferenceRuntime

    if graph is None:
        graph = Graph.load(args.data, native=None if args.native else False)
    features = args.features.split(",") if args.features else []
    dims = [int(x) for x in args.dims.split(",")]
    # each replica gets its OWN flow over the shared graph: a flow is
    # only ever queried from its replica's single batcher thread
    if args.full_neighbor:
        flow = FullNeighborDataFlow(
            graph,
            features,
            num_hops=len(dims),
            max_degree=args.max_degree,
            label_feature=args.label_feature,
        )
    else:
        flow = SageDataFlow(
            graph,
            features,
            fanouts=[int(x) for x in args.fanouts.split(",")],
            label_feature=args.label_feature,
            rng=np.random.default_rng(args.seed),
        )
    in_dim = sum(graph.meta.feature_spec(f).dim for f in features)
    model = GraphSAGESupervised(in_dim=in_dim, dims=dims, label_dim=args.label_dim,
                                conv=args.conv)
    return InferenceRuntime(
        model,
        flow,
        EstimatorConfig(model_dir=args.model_dir) if args.model_dir else None,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        params=params,
        device=device if device is not None else args.device,
    )


def serve_fleet(args) -> list:
    """Boot args.replicas ModelServers over one shared graph."""
    from euler_tpu_torch.distributed.rendezvous import make_registry
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.serving import ModelServer

    registry = make_registry(args.registry) if args.registry else None
    graph = Graph.load(args.data, native=None if args.native else False)
    servers = []
    for i in range(args.replicas):
        runtime = build_runtime(args, graph=graph)
        port = args.port + i if args.port else 0
        server = ModelServer(
            runtime,
            host=args.host,
            port=port,
            max_batch=args.max_batch,
            max_wait_us=args.max_wait_us,
            max_queue=args.max_queue,
            registry=registry,
            shard=args.replica + i,
        )
        runtime.warmup()
        servers.append(server.start())
    return servers


def _ckpt_signature(model_dir: str) -> tuple:
    """Change token for the reload watcher: moves ONLY when a new
    COMPLETE checkpoint commits (training/checkpoint.py COMMIT marker),
    so a poll landing mid-write can never trigger a swap onto a torn
    checkpoint."""
    from euler_tpu_torch.training.checkpoint import watch_signature

    return watch_signature(model_dir)


def watch_reload(servers, model_dir: str, stop_event, poll_s: float):
    """Hot-swap every replica whenever a new COMPLETE checkpoint lands
    under model_dir — the serving fleet never restarts for a deploy,
    and never loads a half-written one."""
    last = _ckpt_signature(model_dir)
    while not stop_event.wait(poll_s):
        now = _ckpt_signature(model_dir)
        if now == last:
            continue
        last = now
        for server in servers:
            try:
                report = server.runtime.swap()
                print(
                    f"hot-reloaded {server.host}:{server.port}: "
                    f"{json.dumps(report)}",
                    flush=True,
                )
            except Exception as e:  # keep serving the old checkpoint
                print(
                    f"hot-reload FAILED on {server.host}:{server.port}: "
                    f"{e!r} (replica keeps its current checkpoint)",
                    flush=True,
                )


def selftest_graph(n: int = 48):
    """The JAX selftest's graph (euler_tpu/tools/serve.py:275-307),
    built from arrays: nodes 1..n with 4-wide normal features drawn in
    node order from default_rng(0) and label [1, 0]; node i's out-edges
    go to i+1, i+2 and i+3 (mod n), weight 1."""
    from euler_tpu_torch.datasets.synthetic import synthetic_meta
    from euler_tpu_torch.graph import Graph, GraphStore

    rng = np.random.default_rng(0)
    feat = np.stack([rng.normal(size=4) for _ in range(n)]).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.uint64)
    hops = (1, 2, 3)
    dst = np.array([(i + d) % n + 1 for i in range(n) for d in hops], np.uint64)
    e = len(dst)
    ew = np.ones(e, np.float32)
    meta = synthetic_meta(4, 2, 1)
    arrays = {
        "node_ids": ids,
        "node_types": np.zeros(n, np.int32),
        "node_weights": np.ones(n, np.float32),
        "edge_src": np.repeat(ids, len(hops)),
        "edge_dst": dst,
        "edge_types": np.zeros(e, np.int32),
        "edge_weights": ew,
        "adj_0_indptr": np.arange(0, e + 1, len(hops), dtype=np.int64),
        "adj_0_dst": dst,
        "adj_0_w": ew,
        "adj_0_eidx": np.arange(e, dtype=np.int64),
        "nf_dense_0": feat,
        "nf_dense_1": np.tile(np.array([1.0, 0.0], np.float32), (n, 1)),
        "glabel_indptr": np.zeros(1, np.int64),
        "glabel_nodes": np.zeros(0, np.uint64),
    }
    meta.node_weight_sums.append([float(n)])
    meta.edge_weight_sums.append([float(e)])
    return Graph(meta, [GraphStore(meta, arrays, part=0)])


def selftest(
    replicas: int = 1,
    hedge_ms: float | None = None,
    replication: int = 1,
    device: str = "cuda",
) -> int:
    """In-process boot: the 48-node graph → 2-step checkpoint → fleet +
    concurrent clients → bit-parity vs direct inference. Exit 0 = the
    serving path works end to end on this host. replicas > 1 also proves
    routed parity, fleet stats, and hot-reload canary parity."""
    import tempfile

    from euler_tpu_torch.dataflow import FullNeighborDataFlow
    from euler_tpu_torch.estimator import (
        Estimator,
        EstimatorConfig,
        id_batches,
        node_batches,
    )
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import (
        InferenceRuntime,
        ModelServer,
        ServingClient,
    )

    if replication > 1:
        raise NotImplementedError(_NOT_PORTED_REPLICATION)
    n = 48
    graph = selftest_graph(n)

    def mkflow():
        return FullNeighborDataFlow(
            graph, ["feat"], num_hops=2, max_degree=4, label_feature="label"
        )

    flow = mkflow()
    model = GraphSAGESupervised(4, [8, 8], 2)
    tmp = tempfile.mkdtemp(prefix="etpu_serve_selftest_")
    servers = []
    try:
        cfg = EstimatorConfig(model_dir=tmp, total_steps=2, log_steps=10**9)
        est = Estimator(
            model, node_batches(graph, flow, 16, rng=np.random.default_rng(1)),
            cfg, device=device,
        )
        est.train(log=False)

        all_ids = np.arange(1, n + 1, dtype=np.uint64)
        _, direct = est.infer(*id_batches(flow, all_ids, 16))

        for i in range(max(1, replicas)):
            runtime = InferenceRuntime(
                model, mkflow(), cfg, buckets=(16,), device=device
            )
            runtime.warmup()
            servers.append(
                ModelServer(runtime, max_wait_us=5000, shard=i).start()
            )
        addrs = [(s.host, s.port) for s in servers]
        results: dict = {}

        def worker(k: int):
            client = ServingClient(
                addrs,
                deadline_ms=60_000,
                routing="consistent_hash" if len(addrs) > 1 else None,
                hedge_ms=hedge_ms,
            )
            try:
                ids = all_ids[k * 6 : (k + 1) * 6]
                results[k] = (ids, client.predict(ids))
            finally:
                client.close()

        threads = [
            threading.Thread(target=worker, args=(k,)) for k in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        ok = not any(t.is_alive() for t in threads) and len(results) == 8
        ok = ok and all(
            np.array_equal(emb, direct[ids.astype(np.int64) - 1])
            for ids, emb in results.values()
        )
        stats_client = ServingClient(addrs, deadline_ms=60_000)
        stats = stats_client.stats()
        fleet = stats_client.fleet_stats()
        reload_parity = None
        if len(addrs) > 1:
            # rolling hot reload of the same checkpoint: canary rows must
            # be bit-identical pre/post swap on every replica
            reports = stats_client.reload(canary_ids=all_ids[:16])
            reload_parity = all(
                r.get("canary_parity") is True for r in reports.values()
            )
            ok = ok and reload_parity and len(fleet) == len(addrs)
        stats_client.close()
    finally:
        for s in servers:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    requests = sum(
        s.get("requests", 0) for s in fleet.values() if "error" not in s
    )
    batches_n = sum(
        s.get("batches", 0) for s in fleet.values() if "error" not in s
    )
    if len(addrs) == 1:
        requests, batches_n = stats["requests"], stats["batches"]
    out = {
        "selftest": "ok" if ok else "MISMATCH",
        "durability": "not ported",
        "device": str(device),
        "replicas": len(addrs),
        "requests": requests,
        "batches": batches_n,
        "coalesced": batches_n < requests,
    }
    if reload_parity is not None:
        out["reload_parity"] = reload_parity
    print(json.dumps(out))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replication > 1:
        raise NotImplementedError(_NOT_PORTED_REPLICATION)
    if args.selftest:
        return selftest(
            replicas=args.replicas,
            hedge_ms=args.hedge,
            replication=args.replication,
            device=args.device,
        )
    if not args.data or not args.model_dir:
        ap.error("--data and --model-dir are required (or --selftest)")
    servers = serve_fleet(args)
    for server in servers:
        print(
            f"serving model on {server.host}:{server.port} "
            f"(replica {server.shard}, buckets {server.runtime.buckets}, "
            f"max_batch {server.batcher.max_batch}, max_wait "
            f"{int(server.batcher.max_wait_s * 1e6)}us, "
            f"device {server.runtime.device})",
            flush=True,
        )
    print(
        json.dumps({
            "fleet": [f"{s.host}:{s.port}" for s in servers],
            "routing": "consistent_hash",
            "hedge_ms": args.hedge,
            "hot_reload": bool(args.reload),
        }),
        flush=True,
    )
    stop_event = threading.Event()
    if args.reload:
        threading.Thread(
            target=watch_reload,
            args=(servers, args.model_dir, stop_event,
                  float(os.environ.get("EULER_TPU_RELOAD_POLL_S", 10.0))),
            daemon=True,
            name="ckpt-reload-watch",
        ).start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        stop_event.set()
        for server in servers:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
