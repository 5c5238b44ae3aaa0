"""Atomic retained checkpoints, read side
(counterpart: euler_tpu/training/checkpoint.py).

A checkpoint is a step-numbered directory under model_dir,
`ckpt_<step:012d>/`, holding a tensor dir of the params and optimizer
leaves (flattened in the JAX tree order), a `meta.json` and, written
last, a `COMMIT` marker. Only directories whose marker exists and parses
count, so a reader never sees a torn checkpoint. The port reads what the
JAX `Estimator.save` wrote; writing comes with the training slice.
"""

from __future__ import annotations

import json
import os

from euler_tpu_torch.graph import format as tformat

PREFIX = "ckpt_"
MARKER = "COMMIT"


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
    """The retained checkpoints under one model_dir."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

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
