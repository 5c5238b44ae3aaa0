"""Weights carried across from the JAX package, and a seeded init.

A flax Dense keeps `kernel` [in, out] and `bias` [out]; a torch
nn.Linear keeps `weight` [out, in] and `bias` [out]. Module paths map
one to one: `params/net/gnn/convs_<i>/Dense_0/kernel` becomes
`net.gnn.convs.<i>.linear.weight` (transposed), `params/out/bias` becomes
`out.bias`.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _torch_key(path: tuple) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"convs_(\d+)", p)
        if m:
            parts += ["convs", m.group(1)]
        elif p == "Dense_0":
            parts.append("linear")
        elif p == "kernel":
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def _leaves(tree, prefix=()):
    """(path, leaf) in sorted-key order — the order of flax's tree_flatten."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(tree) -> dict[str, torch.Tensor]:
    """The port's state_dict (f32 CPU tensors) from a flax param tree,
    with or without the top-level "params" collection; leaves may be
    numpy arrays or anything `np.asarray` reads."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _leaves(tree):
        a = np.array(leaf, dtype=np.float32)  # a writable copy
        if path[-1] == "kernel":
            if a.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel must be 2-D, got {a.shape}")
            a = np.ascontiguousarray(a.T)
        out[_torch_key(path)] = torch.from_numpy(a)
    return out


def from_checkpoint_leaves(leaves) -> dict[str, torch.Tensor]:
    """The port's state_dict from a checkpoint's param leaves in flax
    tree_flatten order, for GraphSAGESupervised without an encoder: one
    (bias, kernel) pair per conv, then the `out` head's pair."""
    leaves = list(leaves)
    if len(leaves) < 4 or len(leaves) % 2:
        raise ValueError(
            f"expected (bias, kernel) pairs for >=1 conv plus the out head, "
            f"got {len(leaves)} leaves"
        )
    num_convs = len(leaves) // 2 - 1
    paths = sorted(
        [("net", "gnn", f"convs_{i}", "Dense_0", k)
         for i in range(num_convs) for k in ("bias", "kernel")]
        + [("out", "bias"), ("out", "kernel")]
    )
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        want = 2 if path[-1] == "kernel" else 1
        if np.ndim(leaf) != want:
            raise ValueError(
                f"leaf for {'/'.join(path)} has shape {np.shape(leaf)}; "
                "the checkpoint is not a GraphSAGESupervised without encoder"
            )
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return from_flax(tree)


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Re-initialise every nn.Linear of `model` the way flax's Dense does
    by default (lecun_normal kernel: truncated normal at ±2σ, σ =
    sqrt(1/fan_in)/0.8796…; zero bias), drawing from `generator`.
    Returns the model's state_dict."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2 * std, b=2 * std, generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
    return model.state_dict()
