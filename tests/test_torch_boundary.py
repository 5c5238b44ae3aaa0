"""The PyTorch port stands alone: importing euler_tpu_torch and every one
of its modules loads nothing of JAX, of the JAX package or of bench.py,
no source of the port (or its scripts at the root) imports them, and no `except`
silences a kernel build or launch, or the native graph engine's build."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "euler_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "euler_tpu", "bench"}
# calls that build or launch a kernel: by last name, or qualified
KERNEL_CALLS = {
    "build_all", "_launch", "_launch_dx", "_run", "gather_weighted_sum",
    "gather_weighted_sum_dx", "paged_gather",
    "paged_gather_dequant", "paged_cdf_count", "paged_sample_hop", "paged_topk_score",
    "paged_topk_select", "_lib",
    "_build.load",
    # a training step, which launches the step's kernels
    "_update", "_step", "_watched_step",
    # the native graph engine's build and load
    "build_host", "build_engine", "_load_lib",
}
# the port's scripts at the root of the repo
SCRIPTS = ("chip_smoke.py", "select_short_list.py", "gws_variants.py", "train_step_ab.py")
# every module of the slices ported so far
PORTED = [
    "euler_tpu_torch.serving.runtime", "euler_tpu_torch.ops.gather_weighted_sum",
    "euler_tpu_torch.ops.paged", "euler_tpu_torch.dataflow.device",
    "euler_tpu_torch.distributed.codec", "euler_tpu_torch.estimator.estimator",
    "euler_tpu_torch.estimator.feature_cache", "euler_tpu_torch.nn.metrics",
    "euler_tpu_torch.training.checkpoint", "euler_tpu_torch.params",
    "euler_tpu_torch.graph.index", "euler_tpu_torch.ops.topk_score",
    "euler_tpu_torch.retrieval", "euler_tpu_torch.retrieval.corpus",
    "euler_tpu_torch.retrieval.topk", "euler_tpu_torch.retrieval.server",
    "euler_tpu_torch.tools.knn", "euler_tpu_torch.training.session",
    "euler_tpu_torch.tools.train", "euler_tpu_torch.estimator.prefetch",
    "euler_tpu_torch.datasets.quality", "euler_tpu_torch.dataflow.sage",
    "euler_tpu_torch.graph.native",
    "euler_tpu_torch.distributed.errors", "euler_tpu_torch.distributed.wire",
    "euler_tpu_torch.distributed.retry", "euler_tpu_torch.distributed.chaos",
    "euler_tpu_torch.distributed.registry", "euler_tpu_torch.distributed.rendezvous",
    "euler_tpu_torch.distributed.service", "euler_tpu_torch.distributed.client",
    "euler_tpu_torch.serving.batcher", "euler_tpu_torch.serving.server",
    "euler_tpu_torch.serving.router", "euler_tpu_torch.serving.client",
    "euler_tpu_torch.tools.serve",
    "euler_tpu_torch.retrieval.router", "euler_tpu_torch.retrieval.client",
    "euler_tpu_torch.tools.retrieve",
    "euler_tpu_torch.ops.mp_ops", "euler_tpu_torch.layers.conv",
    "euler_tpu_torch.dataflow.whole", "euler_tpu_torch.examples.conv_quality",
    "euler_tpu_torch.nn.cells", "euler_tpu_torch.nn.pooling",
    "euler_tpu_torch.models.graph_clf", "euler_tpu_torch.examples.graph_clf_quality",
    "euler_tpu_torch.dataflow.layerwise", "euler_tpu_torch.dataflow.relation",
    "euler_tpu_torch.models.rgcn", "euler_tpu_torch.models.layerwise_models",
    "euler_tpu_torch.models.autoencoders", "euler_tpu_torch.examples.link_quality",
    "euler_tpu_torch.examples.run_model",
    "euler_tpu_torch.nn.history", "euler_tpu_torch.models.scalable",
    "euler_tpu_torch.nn.encoders", "euler_tpu_torch.nn.aggregators",
    "euler_tpu_torch.nn.embedding",
]


def _sources():
    out = [os.path.join(ROOT, f) for f in SCRIPTS]
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(("_build", "__")))
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _forbidden_imports(tree) -> list:
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def _called_names(nodes) -> set:
    """Each call's last name and, for `a.b(...)`, its qualified name."""
    names = set()
    for n in nodes:
        for c in ast.walk(n):
            if not isinstance(c, ast.Call):
                continue
            f = c.func
            if isinstance(f, ast.Attribute):
                names.add(f.attr)
                if isinstance(f.value, ast.Name):
                    names.add(f"{f.value.id}.{f.attr}")
            elif isinstance(f, ast.Name):
                names.add(f.id)
    return names


def _silencing_handlers(tree, strict: bool) -> list:
    """Lines of `except` handlers that do not re-raise: in a kernel module
    (strict) any of them; elsewhere those guarding a kernel build or
    launch."""
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        guards_kernel = bool(_called_names(node.body) & KERNEL_CALLS)
        for h in node.handlers:
            raises = any(isinstance(c, ast.Raise) for b in h.body for c in ast.walk(b))
            if (strict or guards_kernel) and not raises:
                bad.append(h.lineno)
    return bad


@pytest.fixture(scope="module", autouse=True)
def import_child():
    """A fresh interpreter that imports every module of the port and
    reports what it loaded, started with the module's first test so that
    its start-up overlaps the source scans; `test_import_loads_no_jax`
    waits for it."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import euler_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "euler_tpu_torch.__path__, 'euler_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps({'mods': mods, 'loaded': sorted(sys.modules)}))\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_stands_alone(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    assert not _forbidden_imports(tree)
    rel = os.path.relpath(path, ROOT)
    strict = rel in SCRIPTS or rel.startswith(os.path.join("euler_tpu_torch", "ops"))
    assert not _silencing_handlers(tree, strict), f"{rel}: except without raise"


def test_scanner_flags_what_it_should():
    tree = ast.parse(
        "import jax.numpy as jnp\n"
        "from euler_tpu.ops import gather\n"
        "import bench\n"
        "try:\n    out = gather_weighted_sum(x, s, w)\n"
        "except RuntimeError:\n    out = ref(x, s, w)\n"
        "try:\n    lib = _build.load('k')\n"
        "except OSError as e:\n    raise RuntimeError('no kernel') from e\n"
        "try:\n    v = int(s)\nexcept ValueError:\n    v = 0\n"
    )
    assert _forbidden_imports(tree) == ["jax.numpy", "euler_tpu.ops", "bench"]
    assert _silencing_handlers(tree, strict=False) == [6]
    assert _silencing_handlers(tree, strict=True) == [6, 14]


def test_import_loads_no_jax(import_child):
    stdout, stderr = import_child.communicate(timeout=120)
    assert import_child.returncode == 0, stderr[-2000:]
    res = json.loads(stdout.strip().splitlines()[-1])
    assert set(PORTED) <= set(res["mods"])
    leaked = [m for m in res["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert not leaked, leaked
