"""One optimizer step as a captured CUDA graph, replayed once a step
(the port's counterpart of the lax.scan body of
euler_tpu/estimator/estimator.py:285-307, which runs K steps a dispatch).

A step's inputs — a device flow's draws or a host batch already on the
card — are copied into static buffers, and one `graph.replay()` runs the
rest of the step: the fanout (device flows), hydration, forward,
backward and the optimizer update. The graph is captured once per shape
signature of the inputs, as JAX compiles one program per shape.

The kernel wrappers count a launch per Python call, and a replay makes
none: `StepGraph` records the launches its capture issued and adds them
once per replay, so the counts stay launches on the card.

Capture rules the step keeps: no host sync inside it, every kernel
launched on the current (capturing) stream, the optimizer built with
`capturable=True` and its state made before capture — the caller runs
the signature's first step eagerly, as a real step, before capturing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.ops import _build


def tree_map(fn, x, *rest):
    """`fn` over the leaves of one or more nests of tuples, dicts and
    dataclasses of one structure (a leaf is anything else), rebuilt in
    that structure; a dict's leaves go in its key order. Raises
    ValueError where the structures differ."""
    if any(type(r) is not type(x) for r in rest):
        raise ValueError(f"mixed types {sorted({type(v).__name__ for v in (x, *rest)})}")
    if isinstance(x, dict):
        if any(list(r) != list(x) for r in rest):
            raise ValueError(f"dicts of keys {sorted({tuple(v) for v in (x, *rest)})}")
        return {k: tree_map(fn, x[k], *(r[k] for r in rest)) for k in x}
    if isinstance(x, tuple):
        if any(len(r) != len(x) for r in rest):
            raise ValueError(f"tuples of lengths {sorted({len(v) for v in (x, *rest)})}")
        return tuple(tree_map(fn, *vs) for vs in zip(x, *rest))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(x)})
    return fn(x, *rest)


def tensor_leaves(x) -> list:
    """The tensors of a nest of tuples, dicts and dataclasses, in order."""
    out = []
    tree_map(lambda v: out.append(v) if isinstance(v, torch.Tensor) else None, x)
    return out


def with_leaves(x, leaves):
    """`x` with its tensors replaced, in order, by those of the iterator
    `leaves`."""
    return tree_map(lambda v: next(leaves) if isinstance(v, torch.Tensor) else v, x)


def signature(x) -> str:
    """Structure, shapes and dtypes of a step's inputs (one graph each):
    the nest's repr with each array and tensor as (type, shape, dtype)."""
    return repr(tree_map(
        lambda v: (type(v).__name__, tuple(v.shape), str(v.dtype))
        if isinstance(v, (torch.Tensor, np.ndarray)) else v, x))


class StepGraph:
    """`step(inputs) -> (loss, metric)` captured once over static copies
    of `inputs`' tensors; `replay(inputs)` copies new inputs in and runs
    it. A failed capture raises."""

    def __init__(self, step, inputs):
        self.static = [torch.empty_like(t) for t in tensor_leaves(inputs)]
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        # thread_local: a Prefetcher's workers may stage batches meanwhile
        capture = torch.cuda.graph(self.graph, capture_error_mode="thread_local")
        with _build.uncounted_launches(capture.capture_stream) as self.launches:
            with capture:
                self.loss, self.metric = step(with_leaves(inputs, iter(self.static)))

    def replay(self, inputs):
        """One step on `inputs` (same signature); returns the static
        (loss, metric), which the next replay overwrites."""
        for s, t in zip(self.static, tensor_leaves(inputs)):
            s.copy_(t)
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self.launches)
        return self.loss, self.metric
