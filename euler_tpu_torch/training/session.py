"""TrainingSession — durable, preemption-safe training over the Estimator
(counterpart: euler_tpu/training/session.py).

- **Atomic retained checkpoints** (`checkpoint.CheckpointStore`): every
  cadence step commits a `ckpt_<step>/` dir via tmp + fsync + rename +
  COMMIT marker, keep-N retained.
- **Async save off the step path**: the step loop only takes host
  copies at the cadence; a background writer commits them.
- **Bit-exact resume**: the checkpoint carries the step, the optimizer
  state, the batch-source cursor (`ResumableSource.cursor`) and the
  per-shard graph-epoch book, so train-2N-straight equals train-N +
  kill + resume-N, params and per-step losses bitwise. The meta is the
  JAX package's: either package resumes the other's checkpoint.
- **Anomaly guard**: an all-finite check over (loss, updated params)
  every `guard_every` steps. torch updates in place, so a guarded step
  first copies the params and the optimizer state into device buffers
  allocated once (`_PreStep`) and puts them back bitwise when the check
  fails: a rejected update leaves both as they were, the contract of the
  JAX package's non-donating step. Policy "skip" drops the poisoned
  update and keeps the position; "rollback" reverts to the last good
  snapshot and retries; "abort" raises. A strike cap turns a persistent
  burst into a typed `AnomalyError`.
- **Hung-step watchdog**: with `step_deadline_s` set, each step runs
  under a wall-clock deadline on a watchdog worker; expiry dumps every
  thread's stack to a file and raises `HungStepError`.
- **SIGTERM drain**: the handler lets the in-flight step finish; the
  loop drains the device losses, flushes a final checkpoint and returns
  with `preempted=True`.

`TrainerSupervisor` (supervised respawn) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import json
import os
import queue
import signal
import sys
import threading
import time

import numpy as np
import torch

from euler_tpu_torch.training.checkpoint import CheckpointStore


class TrainingError(RuntimeError):
    """Base for typed trainer failures (never a silent hang or poison)."""


class AnomalyError(TrainingError):
    """Non-finite loss/params persisted past the strike cap (or the
    policy forbids recovery)."""


class HungStepError(TrainingError):
    """A step exceeded its wall-clock deadline; diagnostics were dumped
    before the abort."""


# ---------------------------------------------------------------------------
# resumable batch sources
# ---------------------------------------------------------------------------


class ResumableSource:
    """A batch source where draw i is a pure function of (seed, i).

    Each call derives a fresh Generator from SeedSequence([seed, i]), so
    `seek(i)` replays the stream from any position: the cursor is the
    checkpointable dataflow position. `draw_fn(rng) -> tuple` builds one
    batch."""

    is_resumable = True

    def __init__(self, draw_fn, seed: int = 0, start: int = 0):
        self._draw_fn = draw_fn
        self._seed = int(seed)
        self._i = int(start)

    def __call__(self) -> tuple:
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, self._i]))
        self._i += 1
        return self._draw_fn(rng)

    def cursor(self) -> int:
        """Number of draws taken so far (the checkpointed position)."""
        return self._i

    def seek(self, i: int) -> None:
        self._i = int(i)


def resumable_node_batches(
    graph, flow, batch_size: int, node_type: int = -1, seed: int = 0
) -> ResumableSource:
    """`node_batches` with a checkpointable cursor: the roots and the
    flow's neighbour sampling both draw from the per-draw Generator, so a
    resumed trainer regenerates batch i bitwise."""

    def draw(rng):
        if getattr(flow, "rng", None) is not None:
            flow.rng = rng  # sampling flows: make the draw pure in (seed, i)
        roots = graph.sample_node(batch_size, node_type, rng=rng)
        return (flow.query(roots),)

    return ResumableSource(draw, seed=seed)


# ---------------------------------------------------------------------------
# watchdog, async writer and the pre-step copy
# ---------------------------------------------------------------------------


class _DeadlineRunner:
    """Run closures on a daemon worker with a wall-clock deadline.

    A step blocked in the runtime cannot be interrupted from Python; the
    session abandons the wait instead, and a fresh worker serves any
    later call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q: queue.Queue | None = None

    def _ensure(self) -> queue.Queue:
        with self._lock:
            if self._q is None:
                self._q = queue.Queue()
                threading.Thread(
                    target=self._loop, args=(self._q,), daemon=True,
                    name="training-step-deadline",
                ).start()
            return self._q

    @staticmethod
    def _loop(q: queue.Queue):
        while True:
            fn, box, done = q.get()
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller's thread
                box["exc"] = e
            done.set()

    def call(self, fn, timeout_s: float):
        q = self._ensure()
        done = threading.Event()
        box: dict = {}
        q.put((fn, box, done))
        if not done.wait(timeout_s):
            with self._lock:
                self._q = None  # the worker is wedged; abandon it
            raise TimeoutError(f"step exceeded {timeout_s:.3f}s deadline")
        if "exc" in box:
            raise box["exc"]
        return box["result"]


class _StepToken:
    """What a watched step and its watchdog agree on: once the watchdog
    abandons the step, the step may no longer start its update; if the
    update had started, the model's state is not known."""

    def __init__(self):
        self.lock = threading.Lock()
        self.abandoned = False
        self.started = False


class _Abandoned(Exception):
    """Raised inside a step the watchdog gave up on, before its update."""


class _AsyncSaver:
    """Background checkpoint writer: the step path hands over host
    snapshots; commits happen off it. Bounded queue (2), so a slow disk
    backpressures instead of piling up host copies of the model."""

    def __init__(self, store: CheckpointStore):
        self._store = store
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._lock = threading.Lock()
        self._error: Exception | None = None
        self._thread: threading.Thread | None = None

    def _ensure(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="training-ckpt-writer"
                )
                self._thread.start()

    def _loop(self):
        while True:
            step, p, o, meta = self._q.get()
            try:
                self._store.save_leaves(step, p, o, meta)
            except Exception as e:  # surfaced at the next submit/drain
                with self._lock:
                    self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise TrainingError(f"async checkpoint save failed: {err!r}") from err

    def submit(self, step, p_leaves, o_leaves, meta):
        self._raise_pending()
        self._ensure()
        self._q.put((step, p_leaves, o_leaves, meta))

    def drain(self):
        """Block until every queued save committed; surface failures."""
        if self._thread is not None:
            self._q.join()
        self._raise_pending()


class _PreStep:
    """Copies of the params and the optimizer state taken just before a
    guarded step, into buffers allocated once on their devices; `load`
    puts them back bitwise, and drops optimizer slots the step created."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer):
        self.params = list(model.parameters())
        self.optimizer = optimizer
        self._bufs: dict = {}
        self._state: dict = {}

    def _copy(self, key, t: torch.Tensor) -> torch.Tensor:
        b = self._bufs.get(key)
        if b is None or b.shape != t.shape or b.dtype != t.dtype or b.device != t.device:
            b = self._bufs[key] = torch.empty_like(t)
        return b.copy_(t)

    @torch.no_grad()
    def save(self) -> None:
        state = {}
        for i, p in enumerate(self.params):
            self._copy(("p", i), p)
            st = self.optimizer.state.get(p)
            if st:
                state[i] = {k: self._copy(("o", i, k), v) if isinstance(v, torch.Tensor) else v
                            for k, v in st.items()}
        self._state = state

    @torch.no_grad()
    def load(self) -> None:
        opt_state = self.optimizer.state
        for i, p in enumerate(self.params):
            p.copy_(self._bufs[("p", i)])
            want = self._state.get(i)
            if want is None:
                opt_state.pop(p, None)
                continue
            st = opt_state[p]
            for k in [k for k in st if k not in want]:
                del st[k]
            for k, v in want.items():
                if isinstance(v, torch.Tensor) and isinstance(st.get(k), torch.Tensor):
                    st[k].copy_(v)
                else:
                    st[k] = v.clone() if isinstance(v, torch.Tensor) else v


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SessionConfig:
    checkpoint_every: int = 50  # steps between retained checkpoints (0 = end only)
    keep: int = 3  # retained complete checkpoints
    async_save: bool = True
    anomaly_policy: str = "skip"  # off | skip | rollback | abort
    guard_every: int = 1  # steps between all-finite checks (a device sync each)
    max_strikes: int = 3  # anomalies per checkpoint interval before AnomalyError
    step_deadline_s: float = 0.0  # 0 = watchdog off
    handle_sigterm: bool = True  # drain + final checkpoint on SIGTERM
    drain_every: int = 1024  # device loss history drain chunk


class TrainingSession:
    """Durable training-session layer over one Estimator.

    `source` is the estimator's batch source when it has the cursor
    protocol (`ResumableSource`); device flows need none (their batch
    stream derives from the global step). `graph` (optional) feeds the
    checkpointed graph-epoch book. Requires `cfg.steps_per_call == 1` on
    the estimator, as the JAX package's session does: a call of several
    steps would put checkpoint, anomaly and preemption boundaries inside
    one dispatch."""

    def __init__(self, est, source=None, graph=None, cfg: SessionConfig | None = None):
        if int(getattr(est.cfg, "steps_per_call", 1)) > 1:
            raise ValueError(
                "TrainingSession drives single-step dispatches "
                "(steps_per_call=1): checkpoint, anomaly, and preemption "
                "boundaries must fall between optimizer steps"
            )
        self.est = est
        self.source = source
        self.graph = graph
        self.cfg = cfg or SessionConfig()
        if self.cfg.anomaly_policy not in ("off", "skip", "rollback", "abort"):
            raise ValueError(f"anomaly_policy: {self.cfg.anomaly_policy!r}")
        self.store = CheckpointStore(est.cfg.model_dir, keep=self.cfg.keep)
        self._saver = _AsyncSaver(self.store)
        self._runner = _DeadlineRunner()
        self._pre = _PreStep(est.model, est.optimizer)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._last_good: dict | None = None
        self._strikes = 0
        self._last_saved_step: int | None = None
        self._resumed_from: int | None = None
        # set when a step hung inside its update: the model's state is
        # then unknown, and no checkpoint is taken of it
        self._state_unknown = False
        self.telemetry = {
            "steps": 0,
            "saves": 0,
            "async_saves": 0,
            "save_stall_ms_total": 0.0,
            "anomalies": 0,
            "rollbacks": 0,
            "skipped_steps": [],
            "hung_aborts": 0,
            "preemptions": 0,
        }

    # -- state snapshot / restore ---------------------------------------------

    def _cursor(self):
        if self.source is not None and hasattr(self.source, "cursor"):
            return int(self.source.cursor())
        if self.est.flow is not None:
            return int(self.est.step)  # device-flow draws derive from the step
        return None

    def _epoch_book(self) -> dict:
        """Per-shard graph epoch at checkpoint time: which data version
        each step trained against."""
        book: dict = {}
        for i, sh in enumerate(getattr(self.graph, "shards", []) or []):
            ep = getattr(sh, "graph_epoch", None)
            if ep is not None:
                book[str(i)] = int(ep)
        return book

    def _snapshot_state(self) -> dict:
        """Host copies of the trainer state: the async writer's input and
        the anomaly guard's rollback point."""
        p, o = self.est.state_leaves()
        return {"step": int(self.est.step), "cursor": self._cursor(), "p": p, "o": o}

    def _install_state(self, snap: dict) -> None:
        est = self.est
        est.load_leaves(snap["p"], snap["o"])
        est.step = int(snap["step"])
        if self.source is not None and snap.get("cursor") is not None and \
                hasattr(self.source, "seek"):
            self.source.seek(int(snap["cursor"]))

    def restore(self) -> dict | None:
        """Resume from the newest complete retained checkpoint (either
        package's): params, optimizer state, step, source cursor. Returns
        the resume report (with the saved and live graph-epoch books), or
        None when there is nothing to resume from."""
        step = self.store.latest_step()
        if step is None:
            return None
        est = self.est
        est._ensure_init()
        ckpt = self.store.load(step)
        p_live, o_live = est.state_leaves()
        if len(ckpt["params"]) != len(p_live) or len(ckpt["opt_state"]) != len(o_live):
            raise TrainingError(
                f"checkpoint ckpt_{step:012d} has "
                f"{len(ckpt['params'])}+{len(ckpt['opt_state'])} leaves but "
                f"the live model has {len(p_live)}+{len(o_live)} — "
                "model/optimizer config drifted from the saved run"
            )
        snap = {"step": step, "cursor": ckpt["meta"].get("cursor"),
                "p": ckpt["params"], "o": ckpt["opt_state"]}
        self._install_state(snap)
        with self._lock:
            self._last_good = snap
            self._last_saved_step = step
            self._resumed_from = step
        saved_book = ckpt["meta"].get("graph_epochs") or {}
        live_book = self._epoch_book()
        return {
            "resumed": True,
            "step": step,
            "cursor": snap["cursor"],
            "graph_epochs": saved_book,
            "live_graph_epochs": live_book,
            "epoch_match": (
                all(live_book.get(k) == v for k, v in saved_book.items())
                if saved_book else None
            ),
        }

    # -- checkpointing --------------------------------------------------------

    def _checkpoint(self, final: bool = False) -> None:
        t0 = time.perf_counter()
        snap = self._snapshot_state()
        with self._lock:
            self._last_good = snap
            self._strikes = 0
        meta = {
            "cursor": snap["cursor"],
            "seed": int(self.est.cfg.seed),
            "graph_epochs": self._epoch_book(),
        }
        if self.cfg.async_save and not final:
            self._saver.submit(snap["step"], snap["p"], snap["o"], meta)
            with self._lock:
                self.telemetry["async_saves"] += 1
        else:
            # a final flush orders behind every queued async commit
            self._saver.drain()
            self.store.save_leaves(snap["step"], snap["p"], snap["o"], meta)
        with self._lock:
            self.telemetry["saves"] += 1
            self.telemetry["save_stall_ms_total"] += (time.perf_counter() - t0) * 1e3
            self._last_saved_step = snap["step"]

    def flush(self) -> None:
        """Commit every in-flight async save (operator surface)."""
        self._saver.drain()

    # -- one step, the guard ---------------------------------------------------

    def _finite(self, loss: torch.Tensor) -> bool:
        """All-finite over the loss and the updated params: a non-finite
        grad reaches the params through the update, so this covers the
        grads too."""
        checks = [torch.isfinite(loss).all()]
        checks += [torch.isfinite(p).all() for p in self.est.model.parameters()]
        return bool(torch.stack(checks).all())

    def _step(self, check: bool, token: _StepToken | None = None):
        """Draw, update and (when `check`) guard one step; a rejected
        update is undone bitwise. Returns (device loss, ok)."""
        est = self.est
        batch = est._next_batch()
        if token is not None:
            with token.lock:
                if token.abandoned:
                    raise _Abandoned()
                token.started = True
        if check:
            self._pre.save()
        loss, _ = est._update(batch)
        ok = True
        if check:
            ok = self._finite(loss)
            if not ok:
                self._pre.load()
        return loss, ok

    def _on_anomaly(self, step_no: int, history: list, losses: list):
        """One non-finite step; its update is already undone. "skip":
        keep the position (the draw was consumed, so cursor parity
        holds). "rollback": revert to the last good snapshot and retry
        from there."""
        with self._lock:
            self.telemetry["anomalies"] += 1
            self._strikes += 1
            strikes = self._strikes
        policy = self.cfg.anomaly_policy
        if policy == "abort" or strikes > self.cfg.max_strikes:
            raise AnomalyError(
                f"non-finite loss/params at step {step_no} "
                f"(policy={policy}, strike {strikes}/{self.cfg.max_strikes})"
            )
        if policy == "skip":
            self.est.step = step_no  # advance past the poisoned batch
            with self._lock:
                self.telemetry["skipped_steps"].append(step_no)
            return
        replayable = self.est.flow is not None or (
            self.source is not None and hasattr(self.source, "seek")
        )
        if self._last_good is None or not replayable:
            raise AnomalyError(
                f"non-finite loss/params at step {step_no} (policy=rollback, but "
                f"last_good={None if self._last_good is None else self._last_good['step']}"
                f" and replayable={replayable})"
            )
        snap = self._last_good
        self._install_state(snap)
        good = snap["step"]
        history[:] = [(s, x) for s, x in history if s <= good]
        losses[:] = [(s, v) for s, v in losses if s <= good]
        with self._lock:
            self.telemetry["rollbacks"] += 1

    # -- SIGTERM drain ----------------------------------------------------------

    def _install_sigterm(self):
        if not self.cfg.handle_sigterm:
            return None
        if threading.current_thread() is not threading.main_thread():
            return None
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._stop.set()

        signal.signal(signal.SIGTERM, handler)
        return prev

    # -- the loop -----------------------------------------------------------------

    def _diag_dump(self, step_no: int, deadline_s: float) -> str:
        path = os.path.join(os.path.abspath(self.est.cfg.model_dir), f"hung_step_{step_no}.txt")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(json.dumps({
                    "step": step_no,
                    "deadline_s": deadline_s,
                    "telemetry": {k: v for k, v in self.telemetry.items()
                                  if not isinstance(v, list)},
                }) + "\n")
                faulthandler.dump_traceback(file=f, all_threads=True)
        except OSError:
            return "<diagnostic dump failed>"
        return path

    def _watched_step(self, step_no: int, check: bool):
        token = _StepToken()
        try:
            return self._runner.call(lambda: self._step(check, token), self.cfg.step_deadline_s)
        except TimeoutError:
            with token.lock:
                token.abandoned = True
                self._state_unknown = token.started
            with self._lock:
                self.telemetry["hung_aborts"] += 1
            diag = self._diag_dump(step_no, self.cfg.step_deadline_s)
            raise HungStepError(
                f"step {step_no} exceeded its {self.cfg.step_deadline_s:.3f}s "
                f"deadline; all-thread diagnostics at {diag}"
            ) from None

    def run(self, steps: int | None = None, log: bool = False) -> dict:
        """Train `steps` more optimizer steps (default: cfg.total_steps)
        with durability, guard, watchdog and drain semantics. Returns
        {"losses", "loss_steps", "start_step", "end_step", "preempted",
        "resumed_from", "telemetry"}."""
        est = self.est
        est._ensure_init()
        total = steps if steps is not None else est.cfg.total_steps
        target = est.step + int(total)
        guard_on = self.cfg.anomaly_policy != "off"
        prev_handler = self._install_sigterm()
        self._stop.clear()
        history: list = []  # (step, device loss) not yet drained
        losses: list = []  # (step, float)
        preempted = False
        est.model.train()
        t0 = time.time()

        def drain():
            if history:
                vals = torch.stack([x for _, x in history]).cpu().tolist()
                losses.extend((s, v) for (s, _), v in zip(history, vals))
                history.clear()

        try:
            while est.step < target:
                if self._stop.is_set():
                    preempted = True
                    with self._lock:
                        self.telemetry["preemptions"] += 1
                    break
                step_no = est.step + 1
                check = guard_on and step_no % max(self.cfg.guard_every, 1) == 0
                if self.cfg.step_deadline_s > 0:
                    loss, ok = self._watched_step(step_no, check)
                else:
                    loss, ok = self._step(check)
                if not ok:
                    self._on_anomaly(step_no, history, losses)
                    continue
                est.step = step_no
                with self._lock:
                    self.telemetry["steps"] += 1
                history.append((step_no, loss))
                if len(history) >= max(self.cfg.drain_every, 1):
                    drain()
                if log and step_no % max(est.cfg.log_steps, 1) == 0:
                    drain()
                    dt = max(time.time() - t0, 1e-9)
                    print(f"step {step_no}: loss={losses[-1][1]:.4f} "
                          f"({(step_no - (target - total)) / dt:.1f} it/s)")
                if self.cfg.checkpoint_every and step_no % self.cfg.checkpoint_every == 0:
                    self._checkpoint()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            exc_live = sys.exc_info()[0] is not None
            try:
                drain()
            except Exception:
                if not exc_live:
                    raise
            # the final flush, on a clean exit and on preemption; after an
            # error the model holds the last accepted state (a rejected
            # update is undone), so a best-effort save keeps real progress
            # without masking the error
            if self._last_saved_step != est.step and not self._state_unknown:
                if exc_live:
                    try:
                        self._checkpoint(final=True)
                    except Exception as e:
                        print(f"# training: best-effort final checkpoint failed: {e!r}",
                              file=sys.stderr)
                else:
                    self._checkpoint(final=True)
            elif not exc_live:
                self._saver.drain()
        return {
            "losses": [v for _, v in losses],
            "loss_steps": [s for s, _ in losses],
            "start_step": target - total,
            "end_step": int(est.step),
            "preempted": preempted,
            "resumed_from": self._resumed_from,
            "telemetry": {k: (list(v) if isinstance(v, list) else v)
                          for k, v in self.telemetry.items()},
        }
