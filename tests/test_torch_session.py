"""euler_tpu_torch TrainingSession and the trainer CLI: bitwise resume in
process and across a fresh `--resume` process, checkpoints that each
package resumes from the other's (cursor, epoch book, continued losses),
the anomaly policies, the watchdog and the SIGTERM drain.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import FullNeighborDataFlow as JaxFullFlow
from euler_tpu.estimator import Estimator as JaxEstimator
from euler_tpu.estimator import EstimatorConfig as JaxConfig
from euler_tpu.graph import Graph as JaxGraph
from euler_tpu.models import GraphSAGESupervised as JaxGraphSAGE
from euler_tpu.training import SessionConfig as JaxSessionConfig
from euler_tpu.training import TrainingSession as JaxSession
from euler_tpu.training import resumable_node_batches as jax_resumable_node_batches
from euler_tpu_torch.dataflow import FullNeighborDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.estimator import Estimator, EstimatorConfig
from euler_tpu_torch.graph import Graph, write_arrays
from euler_tpu_torch.models import GraphSAGESupervised
from euler_tpu_torch.params import from_flax
from euler_tpu_torch.tools.train import main as train_main
from euler_tpu_torch.training import (
    AnomalyError,
    CheckpointStore,
    HungStepError,
    ResumableSource,
    SessionConfig,
    TrainingSession,
    resumable_node_batches,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT, DIMS, LABEL_DIM = 8, [8, 8], 2
WAIT_S = 60  # bound on every wait for a child process


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 120-node graph dir (features "feat", labels "label") written by
    the port."""
    d = str(tmp_path_factory.mktemp("graph"))
    g = random_graph(num_nodes=120, out_degree=4, feat_dim=FEAT, seed=7)
    for p, shard in enumerate(g.shards):
        write_arrays(os.path.join(d, f"part_{p}"), shard.arrays)
    g.meta.save(d)
    return d


def _flow(graph):
    return FullNeighborDataFlow(graph, ["feat"], num_hops=2, max_degree=4,
                                label_feature="label")


def _session(graph, model_dir, cadence=4, source=None, init_params=None, **cfg_kw):
    source = source if source is not None else resumable_node_batches(
        graph, _flow(graph), 8, seed=3)
    est = Estimator(GraphSAGESupervised(FEAT, DIMS, LABEL_DIM), source,
                    EstimatorConfig(model_dir=str(model_dir), log_steps=10**9, seed=0),
                    init_params=init_params, device="cpu")
    sess = TrainingSession(est, source=source, graph=graph,
                           cfg=SessionConfig(checkpoint_every=cadence, **cfg_kw))
    return sess, est, source


def _assert_same_checkpoint(a, b):
    assert a["step"] == b["step"]
    for x, y in zip(a["params"] + a["opt_state"], b["params"] + b["opt_state"], strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_resume_bit_exact_in_process(data, tmp_path):
    g = Graph.load(data, native=False)
    straight, _, _ = _session(g, tmp_path / "straight")
    want = straight.run(10)
    first, _, _ = _session(g, tmp_path / "split")
    got = first.run(5)
    second, est, src = _session(g, tmp_path / "split")
    rep = second.restore()
    assert rep["step"] == 5 and rep["cursor"] == 6  # the init draw, then 5 steps
    assert rep["graph_epochs"] == {"0": 0} and rep["epoch_match"] is True
    tail = second.run(5)
    assert tail["resumed_from"] == 5 and src.cursor() == want["end_step"] + 1
    assert got["losses"] + tail["losses"] == want["losses"]
    assert got["loss_steps"] + tail["loss_steps"] == list(range(1, 11))
    _assert_same_checkpoint(CheckpointStore(str(tmp_path / "split")).load(),
                            CheckpointStore(str(tmp_path / "straight")).load())


def _flax_tree(seed=0):
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": rng.normal(0, i**-0.5, (i, o)).astype(np.float32),
                "bias": rng.normal(0, 0.1, o).astype(np.float32)}

    return {"params": {
        "net": {"gnn": {"convs_0": {"Dense_0": dense(2 * FEAT, DIMS[0])},
                        "convs_1": {"Dense_0": dense(2 * DIMS[0], DIMS[1])}}},
        "out": dense(DIMS[1], LABEL_DIM),
    }}


def _jax_session(jg, model_dir, tree):
    src = jax_resumable_node_batches(
        jg, JaxFullFlow(jg, ["feat"], num_hops=2, max_degree=4, label_feature="label"),
        8, seed=3)
    est = JaxEstimator(JaxGraphSAGE(dims=DIMS, label_dim=LABEL_DIM), src,
                       JaxConfig(model_dir=str(model_dir), log_steps=10**9, seed=0),
                       init_params=jax.tree_util.tree_map(jnp.asarray, tree))
    return JaxSession(est, source=src, graph=jg, cfg=JaxSessionConfig(checkpoint_every=4)), src


@pytest.fixture(scope="module")
def across(data, tmp_path_factory):
    """JAX trains 4 steps and checkpoints; the port resumes that
    checkpoint and both continue 4 steps; then a JAX session resumes the
    port's step-8 checkpoint and both continue 2 more (adam, one flax
    init)."""
    tmp = tmp_path_factory.mktemp("across")
    jg, pg = JaxGraph.load(data, native=False), Graph.load(data, native=False)
    tree = _flax_tree(seed=4)
    jsess, jsrc = _jax_session(jg, tmp / "jax", tree)
    jsess.run(4)
    shutil.copytree(tmp / "jax", tmp / "port")
    jax_tail = jsess.run(4)
    psess, _, psrc = _session(pg, tmp / "port", init_params=from_flax(tree))
    out = {"port_report": psess.restore(), "port_tail": psess.run(4),
           "jax_tail": jax_tail, "jax_cursor": jsrc.cursor(), "port_cursor": psrc.cursor()}
    shutil.copytree(tmp / "port", tmp / "port_copy")
    jsess2, jsrc2 = _jax_session(jg, tmp / "port_copy", _flax_tree(seed=9))
    out["jax_report"] = jsess2.restore()
    out["jax_cursor2"] = jsrc2.cursor()
    out["jax_more"], out["port_more"] = jsess2.run(2), psess.run(2)
    return out


def test_jax_checkpoint_resumed_by_port(across):
    rep = across["port_report"]
    assert rep["step"] == 4 and rep["cursor"] == 4
    assert rep["graph_epochs"] == rep["live_graph_epochs"] == {"0": 0}
    assert across["port_cursor"] == across["jax_cursor"]
    j, p = across["jax_tail"], across["port_tail"]
    assert p["loss_steps"] == j["loss_steps"] == [5, 6, 7, 8]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-3, atol=1e-3)


def test_port_checkpoint_resumed_by_jax(across):
    rep = across["jax_report"]
    assert rep["step"] == 8 and rep["cursor"] == 8
    assert rep["graph_epochs"] == rep["live_graph_epochs"] == {"0": 0}
    assert across["jax_cursor2"] == 8
    j, p = across["jax_more"], across["port_more"]
    assert p["loss_steps"] == j["loss_steps"] == [9, 10]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-3, atol=1e-3)


class _PoisonSource(ResumableSource):
    """A resumable source that writes NaN features into chosen draws; a
    transient poison hits a draw only the first time it is drawn."""

    def __init__(self, draw_fn, seed=0, poison_at=(), transient=False):
        super().__init__(draw_fn, seed=seed)
        self.poison_at, self.transient = set(poison_at), transient

    def __call__(self):
        i = self._i
        batch = super().__call__()
        if i in self.poison_at:
            if self.transient:
                self.poison_at.discard(i)
            batch[0].feats[0][:] = np.nan
        return batch


def _poison_session(tmp_path, graph, poison_at, sub="p", transient=False, **cfg_kw):
    flow = _flow(graph)
    src = _PoisonSource(lambda rng: (flow.query(graph.sample_node(8, -1, rng=rng)),),
                        seed=3, poison_at=poison_at, transient=transient)
    return _session(graph, tmp_path / sub, source=src, **cfg_kw)


def test_anomaly_skip_leaves_the_state_bitwise(data, tmp_path):
    g = Graph.load(data, native=False)
    ref, _, _ = _poison_session(tmp_path, g, (), sub="clean")
    rep_ref = ref.run(5)
    s, est, src = _poison_session(tmp_path, g, {6}, sub="poison")  # draw 6 = step 6
    rep = s.run(5)
    before = est.state_leaves()
    skipped = s.run(1)
    assert skipped["loss_steps"] == [] and est.step == 6
    for a, b in zip(before[0] + before[1], est.state_leaves()[0] + est.state_leaves()[1],
                    strict=True):
        assert np.array_equal(a, b)
    rest = s.run(6)
    assert s.telemetry["anomalies"] == 1 and s.telemetry["rollbacks"] == 0
    assert s.telemetry["skipped_steps"] == [6]
    assert rep["losses"] == rep_ref["losses"]
    assert rest["loss_steps"] == list(range(7, 13)) and np.isfinite(rest["losses"]).all()
    assert src.cursor() == 13  # the poisoned draw was consumed, not re-used


def test_anomaly_strike_cap_raises_typed(data, tmp_path):
    g = Graph.load(data, native=False)
    s, est, _ = _poison_session(tmp_path, g, set(range(5, 100)), sub="cap", max_strikes=3)
    with pytest.raises(AnomalyError, match="strike"):
        s.run(12)
    assert s.telemetry["anomalies"] == 4  # cap 3 + the raising strike
    assert all(np.isfinite(a).all() for a in est.state_leaves()[0])
    # the best-effort final checkpoint keeps the last accepted state
    assert CheckpointStore(str(tmp_path / "cap")).latest_step() == 7


def test_anomaly_rollback_retries_a_transient_fault(data, tmp_path):
    g = Graph.load(data, native=False)
    s, _, _ = _poison_session(tmp_path, g, {6}, sub="rb", transient=True,
                              anomaly_policy="rollback")
    rep = s.run(12)
    t = rep["telemetry"]
    assert t["anomalies"] == 1 and t["rollbacks"] == 1 and t["skipped_steps"] == []
    assert rep["loss_steps"] == list(range(1, 13)) and np.isfinite(rep["losses"]).all()


def test_anomaly_abort_raises_immediately(data, tmp_path):
    g = Graph.load(data, native=False)
    s, _, _ = _poison_session(tmp_path, g, {2}, sub="abort", anomaly_policy="abort")
    with pytest.raises(AnomalyError, match="policy=abort"):
        s.run(6)
    assert s.telemetry["rollbacks"] == 0


def test_hung_step_watchdog_dumps_and_aborts(data, tmp_path):
    g = Graph.load(data, native=False)
    flow = _flow(g)
    calls = [0]

    def draw(rng):
        if calls[0] == 5:  # the init draw is call 0: step 5 hangs
            time.sleep(3.0)
        calls[0] += 1
        return (flow.query(g.sample_node(8, rng=rng)),)

    s, est, _ = _session(g, tmp_path / "w", source=ResumableSource(draw, seed=3))
    s.run(3)
    s.cfg.step_deadline_s = 0.5
    with pytest.raises(HungStepError, match="deadline"):
        s.run(4)  # step 4 passes, step 5's draw hangs
    assert s.telemetry["hung_aborts"] == 1
    body = open(tmp_path / "w" / "hung_step_5.txt", encoding="utf-8").read()
    assert "Thread" in body or "Current thread" in body
    assert CheckpointStore(str(tmp_path / "w")).latest_step() == est.step == 4


def _cli(data, model_dir, total, losses_out, *extra):
    return ["--data", data, "--model-dir", str(model_dir), "--total-steps", str(total),
            "--checkpoint-every", "3", "--batch-size", "8", "--dims", "8,8",
            "--max-degree", "4", "--device", "cpu", "--losses-out", str(losses_out), *extra]


def _losses_by_step(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            seg = json.loads(line)
            out.update(zip(seg["loss_steps"], seg["losses"]))
    return out


def _child(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "euler_tpu_torch.tools.train", *args],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_session_refuses_grouped_steps_as_jax_does():
    """steps_per_call > 1 puts several optimizer steps in one call, so a
    session's checkpoint, anomaly and preemption boundaries could fall
    inside it: both packages refuse it, with the same message."""
    est = types.SimpleNamespace(cfg=types.SimpleNamespace(steps_per_call=2))
    with pytest.raises(ValueError) as want:
        JaxSession(est)
    with pytest.raises(ValueError) as got:
        TrainingSession(est)
    assert str(got.value) == str(want.value) and "steps_per_call=1" in str(got.value)


def test_cli_refuses_what_is_not_ported(data, tmp_path, capsys):
    for flag in (["--cluster", "{}"], ["--registry", "r"], ["--mutate-spec", "s.json"]):
        with pytest.raises(SystemExit) as e:
            train_main(["--data", data, "--model-dir", str(tmp_path), *flag])
        assert e.value.code == 2
        assert "not ported yet" in capsys.readouterr().err
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(["--data", data, "--model-dir", str(tmp_path)])


@pytest.fixture(scope="module", autouse=True)
def cli_runs(data, tmp_path_factory):
    """The two trainer-CLI child processes, started with the module's
    first test so that their start-up (mostly torch's import) overlaps the
    module's other tests; the two CLI tests, last in the module, wait for
    them by calling the fixture. A 3 000-step run gets SIGTERM once its
    first checkpoint is committed (a thread polls for it from the child's
    start; every wait bounded; its steps end on their own if the signal
    were missed), and a --resume child continues an in-process run of 4
    steps to 8, beside an in-process straight run of 8."""
    d = tmp_path_factory.mktemp("cli")
    runs = {"sig": {"dir": d / "sig", "losses": d / "sig.jsonl"},
            "resume": {"ref": d / "ref", "m": d / "m"}}
    procs, errors = {}, []

    def watch_sig():
        try:
            sig, store = procs["sig"], CheckpointStore(str(d / "sig"))
            deadline = time.monotonic() + WAIT_S
            while time.monotonic() < deadline and not store.steps() and sig.poll() is None:
                time.sleep(0.01)
            runs["sig"]["checkpointed"] = bool(store.steps())
            if store.steps():
                sig.send_signal(signal.SIGTERM)
            runs["sig"]["out"] = sig.communicate(timeout=WAIT_S)[0]
            runs["sig"]["rc"] = sig.returncode
        except BaseException as e:  # re-raised by the tests through finish()
            errors.append(e)

    watcher = threading.Thread(target=watch_sig, daemon=True)

    def stop():
        # the watcher reaps the SIGTERM child; the resume child is reaped here
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        if watcher.is_alive():
            watcher.join(WAIT_S)
        if "resume" in procs and "rc" not in runs["resume"]:
            procs["resume"].communicate()

    try:
        procs["sig"] = _child(_cli(data, d / "sig", 3000, d / "sig.jsonl"))
        watcher.start()
        assert train_main(_cli(data, d / "m", 4, d / "m.jsonl")) == 0
        procs["resume"] = _child(_cli(data, d / "m", 8, d / "m.jsonl", "--resume"))
        assert train_main(_cli(data, d / "ref", 8, d / "ref.jsonl")) == 0
    except BaseException:
        stop()
        raise

    def finish():
        if "rc" not in runs["resume"]:
            watcher.join(2 * WAIT_S + 10)
            if errors:
                raise errors[0]
            assert not watcher.is_alive(), "the SIGTERM child's watcher did not finish"
            resume = procs["resume"]
            runs["resume"]["out"] = resume.communicate(timeout=WAIT_S)[0]
            runs["resume"]["rc"] = resume.returncode
        return runs

    yield finish
    stop()


def test_cli_resume_in_a_fresh_process_is_bit_exact(cli_runs):
    run = cli_runs()["resume"]
    assert run["rc"] == 0, run["out"][-1500:]
    tail = json.loads(run["out"].strip().splitlines()[-1])
    assert tail["done"] and tail["step"] == 8 and tail["resumed"]["step"] == 4
    want = _losses_by_step(str(run["ref"]) + ".jsonl")
    assert sorted(want) == list(range(1, 9))
    assert _losses_by_step(str(run["m"]) + ".jsonl") == want
    _assert_same_checkpoint(CheckpointStore(str(run["m"])).load(),
                            CheckpointStore(str(run["ref"])).load())


def test_cli_sigterm_drains_and_flushes_a_final_checkpoint(cli_runs):
    """SIGTERM after the first committed checkpoint: exit 3, the final
    JSON line says preempted, a checkpoint at the preempted step, and a
    loss for every step."""
    run = cli_runs()["sig"]
    assert run["checkpointed"], "the trainer never committed a checkpoint"
    assert run["rc"] == 3, run["out"][-1500:]
    tail = json.loads(run["out"].strip().splitlines()[-1])
    assert tail["preempted"] is True and tail["done"] is False
    store = CheckpointStore(str(run["dir"]))
    assert store.latest_step() == tail["step"] < 3000
    assert sorted(_losses_by_step(run["losses"])) == list(range(1, tail["step"] + 1))
