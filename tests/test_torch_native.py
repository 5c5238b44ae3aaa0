"""euler_tpu_torch's native C++ graph engine: its build (into the port's
own build directory, under a lock, through a temporary file renamed into
place; concurrent builds give one library; an edited source builds
anew; a failing compiler raises; the JAX binding's library file beside
the source is never touched), every bound `NativeGraphStore` call bit for
bit against the JAX package's binding on the same graph dir and seeds (1
and 2 shards, unit and weighted edges), `Graph.load(native=)`, and the
trainer CLI's `--native` split + resume against a straight run.

Both bindings call one library: the JAX binding is pointed at the port's
build (`euler_tpu.graph.native.build_engine` monkeypatched), so no test
here builds or loads `cpp/libeuler_tpu_engine.so`. The engine splits a
call's work over the host's cores, so its draws are compared within one
process only.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import euler_tpu.graph.native as jax_native
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import Graph, GraphStore, write_arrays
from euler_tpu_torch.graph import native
from euler_tpu_torch.graph.native import NativeGraphStore
from euler_tpu_torch.ops import _build
from euler_tpu_torch.tools.train import main as train_main
from euler_tpu_torch.training import CheckpointStore

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIBRARY = os.path.join(ROOT, "cpp", "libeuler_tpu_engine.so")


def _file_state(path):
    if not os.path.exists(path):
        return None
    st = os.stat(path)
    return st.st_ino, st.st_mtime_ns, st.st_size


@pytest.fixture(scope="module", autouse=True)
def jax_library_state():
    """The JAX binding's library file as it was before this module ran."""
    return _file_state(JAX_LIBRARY)


@pytest.fixture(scope="module")
def engine():
    """The port's engine, built once (its JAX twin is pointed at it)."""
    path = native.build_engine()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "build_engine", lambda force=False: path)
    mp.setattr(jax_native, "_lib", None)
    yield path
    mp.undo()


def _write(graph, directory):
    for p, shard in enumerate(graph.shards):
        write_arrays(os.path.join(directory, f"part_{p}"), shard.arrays)
    graph.meta.save(directory)


@pytest.fixture(scope="module", params=[(1, False), (2, False), (1, True)],
                ids=["1shard", "2shards", "weighted"])
def graphs(request, engine, tmp_path_factory):
    """One graph dir written by the port, loaded natively by both."""
    parts, weighted = request.param
    d = str(tmp_path_factory.mktemp("native"))
    _write(random_graph(num_nodes=400, out_degree=6, feat_dim=5, num_partitions=parts,
                        seed=11, weighted=weighted), d)
    return JaxGraph.load(d, native=True), Graph.load(d, native=True)


def _same(a, b):
    """Two results (arrays or tuples of them), dtypes and bits."""
    a, b = ((x if isinstance(x, (tuple, list)) else (x,)) for x in (a, b))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (tuple, list)):
            _same(x, y)
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(y, x)


def _ids():
    ids = np.arange(1, 420, 7, dtype=np.uint64)  # some past the last node
    return np.concatenate([ids, [np.uint64(0xFFFFFFFFFFFFFFFF)]])


def test_store_calls_match_jax_binding(graphs):
    jg, pg = graphs
    assert all(type(s) is NativeGraphStore for s in pg.shards)
    ids = _ids()
    for js, ps in zip(jg.shards, pg.shards):
        mine = ids[ids % np.uint64(len(pg.shards)) == ps.part]
        _same(js.lookup(ids), ps.lookup(ids))
        for name, args in (("sample_node", (50,)), ("sample_node", (30, 0)),
                           ("sample_edge", (40,)),
                           ("sample_neighbor", (mine, None, 7)),
                           ("sample_neighbor", (mine, [0], 3)),
                           ("sample_neighbor_rows", (mine, None, 5))):
            _same(getattr(js, name)(*args, rng=np.random.default_rng(3)),
                  getattr(ps, name)(*args, rng=np.random.default_rng(3)))
        _same(js.degree_sum(mine), ps.degree_sum(mine))
        for sort_by in (None, "id", "weight"):
            for cap in (None, 4):
                _same(js.get_full_neighbor(mine, None, cap, sort_by=sort_by),
                      ps.get_full_neighbor(mine, None, cap, sort_by=sort_by))
        _same(js.get_dense_feature(mine, ["feat", "label"]),
              ps.get_dense_feature(mine, ["feat", "label"]))
        rows = np.asarray([0, 5, -1, ps.num_nodes - 1], np.int64)
        _same(js.get_dense_by_rows(rows, ["feat"]), ps.get_dense_by_rows(rows, ["feat"]))
        _same(js.fanout_with_rows(mine, None, [4, 3], rng=np.random.default_rng(5)),
              ps.fanout_with_rows(mine, None, [4, 3], rng=np.random.default_rng(5)))
        # the same calls counted by each binding's engine handle
        got, want = ps.op_stats(), js.op_stats()
        assert sorted(got) == sorted(want)
        assert {k: v["calls"] for k, v in got.items()} == {k: v["calls"] for k, v in want.items()}
        assert got["sample_fanout"]["calls"] == 1
        ps.reset_op_stats()
        assert not any(v["calls"] for v in ps.op_stats().values())


def test_graph_calls_match_jax(graphs):
    jg, pg = graphs
    ids = _ids()
    for name, args in (("sample_node", (64,)), ("sample_neighbor", (ids, None, 4)),
                       ("fanout_with_rows", (ids, None, [3, 2]))):
        _same(getattr(jg, name)(*args, rng=np.random.default_rng(8)),
              getattr(pg, name)(*args, rng=np.random.default_rng(8)))
    _same(jg.get_full_neighbor(ids, None, 5), pg.get_full_neighbor(ids, None, 5))
    _same(jg.lookup_rows(ids), pg.lookup_rows(ids))
    _same(jg.dense_feature_table(["feat"]), pg.dense_feature_table(["feat"]))
    assert pg.unit_edge_weights() == jg.unit_edge_weights()


def test_load_picks_the_store_classes_jax_picks(graphs, tmp_path):
    jg, _ = graphs
    d = str(tmp_path)
    _write(random_graph(num_nodes=30, out_degree=2, feat_dim=3, num_partitions=2, seed=1), d)
    for flag in (None, True, False):
        want = [type(s).__name__ for s in JaxGraph.load(d, native=flag).shards]
        got = [type(s).__name__ for s in Graph.load(d, native=flag).shards]
        assert got == want == (["GraphStore"] * 2 if flag is False else ["NativeGraphStore"] * 2)
    assert all(type(s) is GraphStore for s in Graph.load(d, native=False).shards)


_BUILD_CHILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("build", sys.argv[1])
build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(build)
build.BUILD_ROOT = sys.argv[2]
print(build.build_host("graph_engine", sys.argv[3]))
"""


@pytest.fixture(scope="module", autouse=True)
def edited_builds(tmp_path_factory):
    """Two processes and two threads that build an edited copy of the
    engine at once, into a build root of their own, started with the
    module's first test (their compile overlaps the tests before
    `test_concurrent_builds_of_an_edited_source_give_one_library`, which
    waits for them)."""
    tmp = tmp_path_factory.mktemp("edited")
    src, root = str(tmp / "graph_engine.cc"), str(tmp / "build")
    with open(native.ENGINE_SOURCE) as f, open(src, "w") as g:
        g.write(f.read() + "\n// an edited copy\n")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, _build.__file__, root, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    paths, errors = [], []

    def build():
        # the module's BUILD_ROOT stays the port's: build_host reads it at
        # call time, so each thread builds through a copy of its own
        try:
            paths.append(_build_host_at(root, src))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    yield {"procs": procs, "threads": threads, "paths": paths, "errors": errors, "root": root}
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _build_host_at(root, src):
    """`_build.build_host` with another BUILD_ROOT, in a copy of the
    module loaded apart (the tests' own module keeps the port's root)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_build_copy", _build.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BUILD_ROOT = root
    return mod.build_host("graph_engine", src)


def test_concurrent_builds_of_an_edited_source_give_one_library(engine, edited_builds):
    """The builds above: one library, at a path other than the
    unedited engine's, with no temporary file beside it, which loads."""
    for t in edited_builds["threads"]:
        t.join(120)
    paths = edited_builds["paths"]
    for p in edited_builds["procs"]:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        paths.append(out.strip().splitlines()[-1])
    assert not edited_builds["errors"] and len(paths) == 4 and len(set(paths)) == 1
    lib = paths[0]
    assert lib.startswith(edited_builds["root"])
    assert os.path.basename(os.path.dirname(lib)) != os.path.basename(os.path.dirname(engine))
    assert sorted(os.listdir(os.path.dirname(lib))) == ["build.log", "libgraph_engine.so", "lock"]
    assert ctypes.CDLL(lib).etpu_load is not None


def test_failing_compiler_raises(tmp_path, monkeypatch):
    cxx = tmp_path / "g++"
    cxx.write_text("#!/bin/sh\n"
                   "if [ \"$1\" = --version ]; then echo 'stand-in 1.0'; exit 0; fi\n"
                   "echo 'stand-in: cannot compile' >&2; exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"(?s)C\+\+ build failed.*cannot compile"):
        native.build_engine(cxx=str(cxx))
    (bdir,) = os.listdir(tmp_path / "build")
    assert "libgraph_engine.so" not in os.listdir(tmp_path / "build" / bdir)


def test_cli_native_split_and_resume_equals_a_straight_run(engine, tmp_path):
    d = str(tmp_path / "g")
    _write(random_graph(num_nodes=120, out_degree=4, feat_dim=8, seed=7), d)

    def run(model_dir, total, *extra):
        args = ["--data", d, "--model-dir", str(tmp_path / model_dir), "--total-steps",
                str(total), "--checkpoint-every", "2", "--batch-size", "8", "--dims", "8,8",
                "--max-degree", "4", "--device", "cpu", "--native",
                "--losses-out", str(tmp_path / f"{model_dir}.jsonl"), *extra]
        assert train_main(args) == 0

    run("straight", 6)
    run("split", 3)
    run("split", 6, "--resume")

    def losses(name):
        out = {}
        with open(tmp_path / f"{name}.jsonl") as f:
            for line in f:
                seg = json.loads(line)
                out.update(zip(seg["loss_steps"], seg["losses"]))
        return out

    want = losses("straight")
    assert sorted(want) == list(range(1, 7)) and losses("split") == want
    a = CheckpointStore(str(tmp_path / "straight")).load()
    b = CheckpointStore(str(tmp_path / "split")).load()
    assert a["step"] == b["step"] == 6
    for x, y in zip(a["params"] + a["opt_state"], b["params"] + b["opt_state"], strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_the_jax_library_file_is_untouched(jax_library_state):
    """Last in the module: after every build and load above, the library
    the JAX binding writes beside the source is as it was (or absent)."""
    assert _file_state(JAX_LIBRARY) == jax_library_state
    assert native.build_engine().startswith(_build.BUILD_ROOT + os.sep)
