"""Model-zoo runner of the port (counterpart: euler_tpu/examples/run_model.py).

    python -m euler_tpu_torch.examples.run_model --model transe --dataset fb15k --synthetic
    python -m euler_tpu_torch.examples.run_model --model deepwalk --dataset cora \\
        --synthetic --device-flow
    python -m euler_tpu_torch.examples.run_model --model graphsage_unsup --synthetic \\
        --device cpu
    python -m euler_tpu_torch.examples.run_model --model gat --dataset cora --synthetic \
        --device-flow

The JAX runner's flags and defaults, plus `--device` (the CUDA card
unless `--device cpu`; `--platform cpu` means the same). The families the
port runs:
  supervised conv:   gcn sage graphsage gat appnp arma sgcn tagcn graph
                     (SuperviseModel over the conv of that name; gat with
                     improved=True, as the JAX runner builds it)
  conv unsupervised: graphsage_unsup
  embeddings:        deepwalk node2vec line
  knowledge graph:   transe transh transr transd distmult rotate
each on the host flow and, with `--device-flow`, on the device flow.
Modes, as the JAX runner runs them: train for every family; evaluate
for the KG family (`kg_rank_eval`) and the supervised convs; infer for
the embedding family (writes embedding_0.npy and ids_0.npy), the
supervised convs and graphsage_unsup; train_and_evaluate for the
supervised convs. The runner refuses the other modes of the embedding
and KG families, and so does the port; graphsage_unsup's
evaluate and train_and_evaluate, which raise a TypeError in the JAX
runner (it feeds the triple model one MiniBatch), are refused too.
Every other model of the JAX zoo exits with a message naming its
ROADMAP item.

--synthetic uses each dataset's offline stand-in; with raw files under
$EULER_TPU_DATA the real datasets load.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

KG_MODELS = {"transe", "transh", "transr", "transd", "distmult", "rotate"}
EMBEDDING_MODELS = ("deepwalk", "node2vec", "line")
# the supervised conv models and the conv each runs (the JAX runner's
# CONV_MODELS, those of its convs the port has)
CONV_MODELS = {"gcn": "gcn", "graphsage": "sage", "sage": "sage", "gat": "gat",
               "appnp": "appnp", "arma": "arma", "sgcn": "sgcn", "tagcn": "tagcn",
               "graph": "graph"}
# the JAX zoo's other models and the ROADMAP item each waits for
NOT_PORTED = {
    **{m: "ROADMAP queue 1 item 4 (the conv zoo's second half)" for m in (
        "agnn", "dna", "gated", "geniepath", "lgcn")},
    **{m: "ROADMAP queue 1 item 4 (graph classification; needs item 3's whole-graph flow)"
       for m in ("gin", "set2set", "gated_graph", "graphgcn")},
    **{m: "ROADMAP queue 1 item 4 (GAE/DGI)" for m in ("gae", "vgae", "dgi")},
    **{m: "ROADMAP queue 1 items 3-4 (the layerwise flow and its model)"
       for m in ("fastgcn", "adaptivegcn")},
    "rgcn": "ROADMAP queue 1 items 3-4 (the relation flow and RGCN)",
    **{m: "ROADMAP queue 1 item 4 (ScalableGNN)" for m in ("scalable_gcn", "scalable_sage")},
}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--mode", default="train",
                    choices=["train", "evaluate", "infer", "train_and_evaluate"])
    ap.add_argument("--model-dir", default="/tmp/euler_tpu_runs")
    ap.add_argument("--hidden-dim", type=int, default=32)
    ap.add_argument("--embedding-dim", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--fanouts", type=int, nargs="*", default=[10, 10])
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--total-steps", type=int, default=100)
    ap.add_argument("--learning-rate", type=float, default=0.01)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--num-negs", type=int, default=5)
    ap.add_argument("--walk-len", type=int, default=5)
    ap.add_argument("--window", type=int, default=2)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--log-steps", type=int, default=20)
    ap.add_argument("--platform", default=None,
                    help="the JAX runner's flag; 'cpu' runs on the CPU (as --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="devices for a data-parallel mesh (0 = single; not ported yet)")
    ap.add_argument("--device-flow", action="store_true",
                    help="sample batches on the device (graphsage_unsup, the supervised convs, "
                         "deepwalk/node2vec/line and the TransX family; local graphs only)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize conv layers on backward (not ported yet)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card, 'cpu' to run on the CPU")
    return ap


def _require_checkpoint(est):
    """evaluate/infer score trained parameters: without a checkpoint,
    exit rather than score a random init."""
    if not est.restore():
        raise SystemExit(
            f"no checkpoint under {est.cfg.model_dir!r} — run --mode train "
            "with the same --model-dir first"
        )


def _refuse(name: str) -> None:
    if name in NOT_PORTED:
        raise SystemExit(f"model {name!r} is not ported to euler_tpu_torch yet: {NOT_PORTED[name]}")
    known = sorted(KG_MODELS) + list(EMBEDDING_MODELS) + ["graphsage_unsup"] + list(CONV_MODELS)
    if name not in known:
        raise SystemExit(f"unknown model {name!r}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    name = args.model
    _refuse(name)
    if args.data_parallel:
        raise SystemExit("--data-parallel is not ported yet (ROADMAP queue 1 item 6: parallelism)")
    device = args.device or ("cpu" if args.platform == "cpu" else None)

    from euler_tpu_torch.datasets import get_dataset
    from euler_tpu_torch.device import resolve_device
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig, id_batches, node_batches
    from euler_tpu_torch.graph import Graph

    device = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    ds = get_dataset(args.dataset) if args.data_dir is None else None
    graph = Graph.load(args.data_dir) if args.data_dir else ds.load_graph(synthetic=args.synthetic)
    max_id = int(max(int(np.asarray(sh.node_ids).max(initial=0)) for sh in graph.shards))

    cfg = EstimatorConfig(
        model_dir=f"{args.model_dir}/{args.model}_{args.dataset}",
        batch_size=args.batch_size,
        total_steps=args.total_steps,
        learning_rate=args.learning_rate,
        optimizer=args.optimizer,
        log_steps=args.log_steps,
        seed=args.seed,
    )
    feature = "feature"
    if args.remat and (name in KG_MODELS or name in EMBEDDING_MODELS):
        print(f"# --remat has no effect for model {name!r} (no conv stack)")
    label_dim = getattr(ds, "num_classes", 2) if ds else 2
    dims = [args.hidden_dim] * args.layers
    flow = None  # set by families that evaluate/infer through a dataflow

    # ---- family dispatch -------------------------------------------------
    if name in KG_MODELS:
        from euler_tpu_torch.models import TransX, kg_batches

        model = TransX(num_entities=max_id, num_relations=graph.meta.num_edge_types,
                       dim=args.embedding_dim, variant=name)
        if args.device_flow:
            from euler_tpu_torch.dataflow import DeviceKGFlow

            bf = DeviceKGFlow(graph, args.batch_size, args.num_negs, device=device)
        else:
            bf = kg_batches(graph, args.batch_size, args.num_negs, rng=rng)
        est = Estimator(model, bf, cfg, device=device)
    elif name in EMBEDDING_MODELS:
        from euler_tpu_torch.models import SkipGramModel, deepwalk_batches, line_batches

        model = SkipGramModel(num_nodes=max_id, dim=args.embedding_dim,
                              shared_context=(name == "line"))
        p = args.p if name == "node2vec" else 1.0
        q = args.q if name == "node2vec" else 1.0
        if args.device_flow:
            from euler_tpu_torch.dataflow import DeviceEdgeFlow, DeviceWalkFlow

            bf = (
                DeviceEdgeFlow(graph, args.batch_size, args.num_negs, device=device)
                if name == "line"
                else DeviceWalkFlow(graph, args.batch_size, args.walk_len, args.window,
                                    args.num_negs, p=p, q=q, device=device)
            )
        else:
            bf = (
                line_batches(graph, args.batch_size, args.num_negs, rng=rng)
                if name == "line"
                else deepwalk_batches(graph, args.batch_size, args.walk_len, args.window,
                                      args.num_negs, p=p, q=q, rng=rng)
            )
        est = Estimator(model, bf, cfg, device=device)
    else:
        from euler_tpu_torch.dataflow import SageDataFlow
        from euler_tpu_torch.estimator import DeviceFeatureCache

        in_dim = graph.meta.feature_spec(feature).dim
        fanouts = args.fanouts[: args.layers]
        if name == "graphsage_unsup":
            from euler_tpu_torch.estimator import unsupervised_batches
            from euler_tpu_torch.models import GraphSAGEUnsupervised

            flow = SageDataFlow(graph, [feature], fanouts=fanouts, rng=rng)
            model = GraphSAGEUnsupervised(in_dim, dims=dims, remat=args.remat)
            if args.device_flow:
                from euler_tpu_torch.dataflow import DeviceUnsupSageFlow

                est = Estimator(
                    model,
                    DeviceUnsupSageFlow(graph, fanouts=fanouts, batch_size=args.batch_size,
                                        num_negs=args.num_negs, device=device),
                    cfg, feature_cache=DeviceFeatureCache(graph, [feature], device=device),
                    device=device,
                )
            else:
                est = Estimator(
                    model,
                    unsupervised_batches(graph, flow, args.batch_size,
                                         num_negs=args.num_negs, rng=rng),
                    cfg, device=device,
                )
        else:  # the supervised conv branch
            from euler_tpu_torch.nn import SuperviseModel

            flow = SageDataFlow(graph, [feature], fanouts=fanouts, label_feature="label",
                                rng=rng)
            conv = CONV_MODELS[name]
            # the JAX runner's GAT (the reference's run_gat.py default):
            # without `improved`, roots with no valid neighbour embed as 0
            conv_kwargs = {"improved": True} if conv == "gat" else None
            model = SuperviseModel(in_dim, conv=conv, dims=dims, label_dim=label_dim,
                                   conv_kwargs=conv_kwargs, remat=args.remat)
            if args.device_flow:
                from euler_tpu_torch.dataflow import DeviceSageFlow

                est = Estimator(
                    model,
                    DeviceSageFlow(graph, fanouts=fanouts, batch_size=args.batch_size,
                                   label_feature="label", root_node_type=0, device=device),
                    cfg, feature_cache=DeviceFeatureCache(graph, [feature], device=device),
                    device=device,
                )
            else:
                est = Estimator(model, node_batches(graph, flow, args.batch_size, 0, rng=rng),
                                cfg, device=device)

    # ---- drive ----------------------------------------------------------
    if args.mode != "train":
        # reject an unsupported mode before demanding a checkpoint
        kg_eval = name in KG_MODELS and args.mode == "evaluate"
        emb_infer = name in EMBEDDING_MODELS and args.mode == "infer"
        flow_mode = flow is not None and (name != "graphsage_unsup" or args.mode == "infer")
        if not (kg_eval or emb_infer or flow_mode):
            raise SystemExit(f"mode {args.mode!r} is not supported for model {name!r}")
    if args.mode != "train" and flow is None:
        _require_checkpoint(est)
        if kg_eval:
            from euler_tpu_torch.models import kg_rank_eval

            if ds is not None and hasattr(ds, "eval_triples") and not args.synthetic:
                triples = ds.eval_triples("test")[:500]
            else:  # offline fallback: rank sampled training edges
                e = graph.sample_edge(200, rng=rng)
                triples = np.stack([e[:, 0], e[:, 2], e[:, 1]], axis=1).astype(np.int32)
            print(kg_rank_eval(est.model, None, triples, num_entities=max_id))
            return 0
        import torch

        ids = np.concatenate([np.asarray(sh.node_ids) for sh in graph.shards])
        with torch.inference_mode():
            emb = est.model.embed(
                torch.as_tensor(ids.astype(np.int64).astype(np.int32), device=device)
            ).cpu().numpy()
        os.makedirs(cfg.model_dir, exist_ok=True)
        np.save(os.path.join(cfg.model_dir, "embedding_0.npy"), emb)
        np.save(os.path.join(cfg.model_dir, "ids_0.npy"), ids)
        print(f"wrote {emb.shape} embeddings to {cfg.model_dir}")
        return 0
    if args.mode == "train":
        hist = est.train()
        if len(hist):
            print(f"trained {len(hist)} steps; final loss {float(hist[-1]):.4f}")
    elif args.mode == "train_and_evaluate":
        splits = ds.splits(graph) if ds else {"val": graph.sample_node(64)}
        batches_fn = lambda: id_batches(flow, splits["val"], args.batch_size)[0]  # noqa: E731
        print(est.train_and_evaluate(batches_fn, eval_every=max(args.total_steps // 2, 1)))
    elif args.mode == "evaluate":
        _require_checkpoint(est)
        splits = ds.splits(graph) if ds else {"test": graph.sample_node(64)}
        batches, _ = id_batches(flow, splits["test"], args.batch_size)
        print(est.evaluate(batches))
    elif args.mode == "infer":
        _require_checkpoint(est)
        splits = ds.splits(graph) if ds else {"test": graph.sample_node(64)}
        ids = np.concatenate(list(splits.values()))
        batches, chunks = id_batches(flow, ids, args.batch_size)
        _, emb = est.infer(batches, chunks)
        print(f"wrote {emb.shape} embeddings to {cfg.model_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
