"""The port's `run_model` CLI on the CPU (`--device cpu`): the JAX runner's
flags and defaults; every family the port runs (of the supervised
convs: sage, gcn, gat and agnn; of graph classification: gin on the
mutag stand-in; gae, vgae, dgi, rgcn, fastgcn and adaptivegcn) trains on
the host flow and on the device flow (`--device-flow`);
train_and_evaluate and evaluate for sage, rgcn and fastgcn, evaluate for
the KG family, infer for the embedding family, sage, graphsage_unsup,
gae, dgi and adaptivegcn, each exiting 0 on `--synthetic` data; the
modes the JAX runner refuses (or cannot run) and unknown models exit
with a message; scalable_gcn and scalable_sage train (ScalableTrainer)
and print their final loss, in every mode, as the JAX runner does."""

import os

import numpy as np
import pytest
import torch

from euler_tpu.examples.run_model import build_parser as jax_build_parser
from euler_tpu_torch.examples.run_model import (
    GRAPH_CLF,
    KG_MODELS,
    SCALABLE_MODELS,
    build_parser,
    main,
)

torch.set_num_threads(1)

STEPS = ["--total-steps", "2", "--batch-size", "8", "--hidden-dim", "8", "--embedding-dim",
         "8", "--fanouts", "3", "2", "--device", "cpu", "--synthetic", "--log-steps", "1000"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One dataset cache and one model root for the module (the stand-ins
    are converted once)."""
    root = tmp_path_factory.mktemp("run_model")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EULER_TPU_DATA", str(root / "data"))
        yield str(root / "runs")


def _dataset(model):
    return "fb15k" if model in KG_MODELS else "mutag" if model in GRAPH_CLF else "cora"


def _run(cache, model, *extra, mode="train"):
    dataset = _dataset(model)
    return main(["--model", model, "--dataset", dataset, "--mode", mode, "--model-dir", cache,
                 *STEPS, *extra])


def test_flags_and_defaults_follow_the_jax_runner():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.nargs)
                for a in parser._actions if a.dest != "help"}

    got, want = actions(build_parser()), actions(jax_build_parser())
    assert got.pop("device") == (["--device"], None, None, None)
    assert got == want


FAMILIES = ["graphsage_unsup", "deepwalk", "node2vec", "line", "sage", "gcn", "gat", "agnn",
            "gin", *sorted(KG_MODELS), "gae", "vgae", "dgi", "rgcn", "fastgcn", "adaptivegcn"]


@pytest.mark.parametrize("flow", ["host", "device"])
@pytest.mark.parametrize("model", FAMILIES)
def test_train_exits_zero(cache, model, flow, capsys):
    extra = ["--device-flow"] if flow == "device" else []
    if model == "node2vec":
        extra += ["--p", "0.5", "--q", "2"]
    assert _run(cache, model, *extra) == 0
    assert "trained 2 steps; final loss" in capsys.readouterr().out


@pytest.mark.parametrize("model", ["scalable_gcn", "scalable_sage"])
def test_scalable_families_train_exit_zero(cache, model, capsys):
    """The JAX smoke's scalable_gcn run (tests/test_datasets_examples.py):
    ScalableTrainer over the stand-in's host HistoryTables, 2 steps,
    `final loss: <finite>` and exit 0; --device-flow is ignored, as the
    JAX runner ignores it."""
    assert _run(cache, model, "--device-flow") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("final loss: ") and np.isfinite(float(line.split()[-1]))


@pytest.mark.parametrize("flow", ["host", "device"])
def test_train_and_evaluate_exits_zero(cache, flow, capsys):
    extra = ["--device-flow"] if flow == "device" else []
    assert _run(cache, "sage", *extra, mode="train_and_evaluate") == 0
    out = capsys.readouterr().out
    assert "'loss'" in out and "'f1'" in out


@pytest.mark.parametrize("model", ["rgcn", "fastgcn"])
@pytest.mark.parametrize("flow", ["host", "device"])
def test_new_families_train_and_evaluate_exit_zero(cache, flow, model, capsys):
    extra = ["--device-flow"] if flow == "device" else []
    assert _run(cache, model, *extra, mode="train_and_evaluate") == 0
    out = capsys.readouterr().out
    assert "'loss'" in out and "'f1'" in out


def test_evaluate_and_infer_exit_zero(cache, capsys):
    """After a train of each: evaluate (KG: kg_rank_eval; sage:
    Estimator.evaluate), infer (embeddings and ids)."""
    for model in ("transe", "deepwalk", "graphsage_unsup", "sage"):
        assert _run(cache, model) == 0
    assert _run(cache, "transe", mode="evaluate") == 0
    assert "mean_rank" in capsys.readouterr().out
    assert _run(cache, "sage", mode="evaluate") == 0
    assert "'f1'" in capsys.readouterr().out
    assert _run(cache, "deepwalk", mode="infer") == 0
    emb = np.load(os.path.join(cache, "deepwalk_cora", "embedding_0.npy"))
    ids = np.load(os.path.join(cache, "deepwalk_cora", "ids_0.npy"))
    assert emb.shape == (len(ids), 8) and np.isfinite(emb).all()
    for model in ("graphsage_unsup", "sage"):
        assert _run(cache, model, mode="infer") == 0
        assert np.load(os.path.join(cache, f"{model}_cora", "embedding_0.npy")).shape[1] == 8


def test_new_families_evaluate_and_infer_exit_zero(cache, capsys):
    """After a train of each: evaluate for rgcn and fastgcn, infer for
    gae, dgi and adaptivegcn (on the device-flow runs' checkpoints for gae
    and dgi)."""
    for model, extra in (("rgcn", ()), ("fastgcn", ()), ("adaptivegcn", ()),
                         ("gae", ("--device-flow",)), ("dgi", ("--device-flow",))):
        assert _run(cache, model, *extra) == 0
    for model in ("rgcn", "fastgcn"):
        assert _run(cache, model, mode="evaluate") == 0
        assert "'f1'" in capsys.readouterr().out
    for model in ("gae", "dgi", "adaptivegcn"):
        assert _run(cache, model, mode="infer") == 0
        emb = np.load(os.path.join(cache, f"{model}_cora", "embedding_0.npy"))
        assert emb.shape[1] == 8 and np.isfinite(emb).all()


@pytest.mark.parametrize("model, mode", [
    ("graphsage_unsup", "evaluate"), ("graphsage_unsup", "train_and_evaluate"),
    ("deepwalk", "evaluate"), ("deepwalk", "train_and_evaluate"),
    ("line", "train_and_evaluate"), ("transe", "train_and_evaluate"), ("transe", "infer"),
    ("gin", "evaluate"), ("set2set", "infer"), ("gae", "evaluate"),
    ("vgae", "train_and_evaluate"), ("dgi", "evaluate")])
def test_modes_the_jax_runner_refuses_exit_with_a_message(cache, tmp_path, model, mode):
    """Refused before a checkpoint is asked for: the model dir is empty."""
    with pytest.raises(SystemExit, match=f"mode '{mode}' is not supported for model '{model}'"):
        main(["--model", model, "--dataset", _dataset(model),
              "--mode", mode, "--model-dir", str(tmp_path), *STEPS])


def test_refusals(cache, tmp_path, capsys):
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--model", "transe", "--dataset", "fb15k", "--mode", "evaluate", "--model-dir",
              str(tmp_path), *STEPS])
    # the scalable pair, the last models the port refused, train: in any
    # mode, as the JAX runner's branch does, ending on its loss line
    assert set(SCALABLE_MODELS) == {"scalable_gcn", "scalable_sage"}
    for model in sorted(SCALABLE_MODELS):
        assert _run(cache, model, mode="evaluate") == 0
        assert "final loss: " in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown model"):
        _run(cache, "nope")
    with pytest.raises(SystemExit, match="item 6"):
        _run(cache, "transe", "--data-parallel", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--model", "transe", "--dataset", "fb15k", "--synthetic",
                  "--model-dir", cache, "--total-steps", "1"])


def test_link_quality_recipes_run(monkeypatch):
    """`examples/link_quality.py`'s recipes (the JAX quality tests'), cut
    to 3 steps on small stand-ins: each reports its metric and band."""
    import euler_tpu_torch.datasets as datasets
    import euler_tpu_torch.examples.link_quality as lq
    from euler_tpu_torch.graph import Graph

    for name in ("LINE_STEPS", "DEEPWALK_STEPS", "TRANSE_STEPS", "GAE_STEPS"):
        monkeypatch.setattr(lq, name, 3)
    g = Graph.from_json(datasets.cora_like_json(num_nodes=300, feature_dim=16,
                                                train_per_class=5, val_n=20, test_n=20))
    for name, band in (("line", lq.LINE_BAND), ("deepwalk", lq.DEEPWALK_BAND)):
        q = lq.skipgram_quality(name, "cpu", graph=g)
        assert q["steps"] == 3 and q["band"] == band and 0 < q["mrr"] <= 1
    for name in ("gae", "vgae"):
        q = lq.gae_quality(name, "cpu", graph=g)
        assert q["steps"] == 3 and q["band"] == lq.GAE_BANDS[name] and 0 <= q["auc"] <= 1
    full = datasets.fb15k_like
    monkeypatch.setattr(datasets, "fb15k_like", lambda: full(n_train=1000, n_test=20))
    q = lq.transe_quality("cpu")
    assert q["steps"] == 3 and 1 <= q["trained"]["mean_rank"] <= 2000
    assert isinstance(q["in_band"], bool)


def test_layerwise_quality_recipes_run(monkeypatch):
    """`examples/conv_quality.py`'s layer-wise recipes (the JAX quality
    tests'), cut to 3 steps on a small stand-in: each reports its F1 and
    band."""
    import euler_tpu_torch.examples.conv_quality as cq
    from euler_tpu_torch.datasets import cora_like_json
    from euler_tpu_torch.graph import Graph

    j = cora_like_json(num_nodes=300, feature_dim=16, train_per_class=5, val_n=20, test_n=20)
    data = Graph.from_json(j), np.asarray([n["type"] for n in j["nodes"]])
    for name, r in cq.LAYERWISE_RECIPES.items():
        monkeypatch.setitem(cq.LAYERWISE_RECIPES, name, r._replace(steps=3))
        q = cq.layerwise_quality(name, "cpu", data)
        assert q["steps"] == 3 and q["band"] == r.band and 0 <= q["f1"] <= 1
