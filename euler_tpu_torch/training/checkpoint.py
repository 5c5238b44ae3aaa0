"""Atomic retained checkpoints
(counterpart: euler_tpu/training/checkpoint.py:53-256, and
`watch_signature` at :266).

A checkpoint is a step-numbered directory under model_dir,
`ckpt_<step:012d>/`, holding a tensor dir of the params and optimizer
leaves (flattened in the JAX tree order), a `meta.json` and, written
last, a `COMMIT` marker. Only directories whose marker exists and parses
count, so a reader never sees a torn checkpoint.

Write protocol (`save_leaves`): everything lands in
`ckpt_<step>.tmp-<pid>` first, every file is fsync'd, the COMMIT marker
goes last, then one `os.replace` publishes the directory and the parent
is fsync'd; `gc` then keeps the newest `keep` complete checkpoints. The
two packages read each other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from euler_tpu_torch.graph import format as tformat

PREFIX = "ckpt_"
MARKER = "COMMIT"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def step_of(name: str) -> int | None:
    """`ckpt_000000000040` -> 40; None for anything else (tmp dirs,
    unrelated files)."""
    if not name.startswith(PREFIX) or ".tmp-" in name:
        return None
    tail = name[len(PREFIX):]
    if not tail.isdigit():
        return None
    return int(tail)


def is_complete(path: str) -> bool:
    """A checkpoint dir counts only with a parseable COMMIT marker."""
    marker = os.path.join(path, MARKER)
    try:
        with open(marker, encoding="utf-8") as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return True


class CheckpointStore:
    """Keep-N atomic retained checkpoints under one model_dir."""

    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = max(int(keep), 1)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"{PREFIX}{int(step):012d}")

    def steps(self) -> list[int]:
        """Committed checkpoint steps, ascending."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            s = step_of(name)
            if s is not None and is_complete(os.path.join(self.root, name)):
                out.append(s)
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: int | None = None) -> dict:
        """Load one complete checkpoint: {"step", "meta", "params",
        "opt_state"} with params/opt_state as leaf lists in tree-flatten
        order. step=None loads the newest complete one."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {self.root!r}"
                )
        path = self._path(step)
        if not is_complete(path):
            raise FileNotFoundError(f"{path}: checkpoint is not complete")
        with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
            meta = json.load(f)
        arrays = tformat.read_arrays(path, mmap=False)

        def leaves(prefix: str, count: int, shapes) -> list:
            # the tensor-dir format promotes 0-d leaves to (1,); the
            # recorded shapes restore them
            shapes = shapes or [None] * count
            return [
                arrays[f"{prefix}_{i:05d}"].reshape(shapes[i])
                if shapes[i] is not None
                else arrays[f"{prefix}_{i:05d}"]
                for i in range(count)
            ]

        return {
            "step": int(meta["step"]),
            "meta": meta,
            "params": leaves(
                "p", int(meta["num_params_leaves"]), meta.get("param_shapes")
            ),
            "opt_state": leaves(
                "o", int(meta["num_opt_leaves"]), meta.get("opt_shapes")
            ),
        }

    def save_leaves(self, step: int, params_leaves, opt_leaves, extra_meta: dict | None = None) -> str:
        """Commit one checkpoint of host numpy leaves atomically; returns
        the committed path. Re-saving a committed step is a no-op."""
        final = self._path(step)
        if os.path.isdir(final) and is_complete(final):
            return final
        os.makedirs(self.root, exist_ok=True)
        tmp = f"{final}.tmp-{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        params_leaves = [np.asarray(v) for v in params_leaves]
        opt_leaves = [np.asarray(v) for v in opt_leaves]
        arrays = {f"p_{i:05d}": v for i, v in enumerate(params_leaves)}
        arrays.update({f"o_{i:05d}": v for i, v in enumerate(opt_leaves)})
        tformat.write_arrays(tmp, arrays, fsync=True)
        meta = {
            "version": 1,
            "step": int(step),
            "num_params_leaves": len(params_leaves),
            "num_opt_leaves": len(opt_leaves),
            "param_shapes": [list(v.shape) for v in params_leaves],
            "opt_shapes": [list(v.shape) for v in opt_leaves],
            "ts": time.time(),
        }
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        # the marker goes LAST: its presence certifies every fsync above
        with open(os.path.join(tmp, MARKER), "w", encoding="utf-8") as f:
            json.dump({"step": int(step), "ts": meta["ts"]}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(final):  # an incomplete husk from a dead writer
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_dir(self.root)
        self.gc()
        return final

    def gc(self) -> list[str]:
        """Reap stale tmp dirs, torn dirs and all but the newest `keep`
        complete checkpoints; returns the removed paths."""
        removed: list[str] = []
        if not os.path.isdir(self.root):
            return removed
        complete = self.steps()
        drop = set(complete[: -self.keep]) if len(complete) > self.keep else set()
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if name.startswith(PREFIX) and ".tmp-" in name:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
                continue
            s = step_of(name)
            if s is not None and (s in drop or not is_complete(path)):
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
        return removed


def watch_signature(model_dir: str) -> tuple:
    """Change-detection token for the serving hot-reload watcher.

    Moves ONLY when a new COMPLETE checkpoint commits: (newest complete
    step, its COMMIT mtime). A half-written `ckpt_*.tmp-*` dir — or a
    torn dir left by a killed trainer — never changes the signature, so
    a watcher poll landing mid-write cannot trigger a swap onto a torn
    checkpoint. Without a complete checkpoint it is ("none", 0, 0.0):
    the JAX package's legacy single-path Orbax dirs, which it also
    watches, are not read by the port."""
    store = CheckpointStore(os.path.abspath(model_dir))
    step = store.latest_step()
    if step is None:
        return ("none", 0, 0.0)
    try:
        return ("retained", step, os.path.getmtime(os.path.join(store._path(step), MARKER)))
    except OSError:
        return ("retained", step, 0.0)
