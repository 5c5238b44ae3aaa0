"""Weights and optimizer state carried between the packages, and a
seeded init.

A flax Dense keeps `kernel` [in, out] and `bias` [out]; a torch
nn.Linear keeps `weight` [out, in] and `bias` [out]. Module paths map
one to one: `params/net/gnn/convs_<i>/Dense_0/kernel` becomes
`net.gnn.convs.<i>.linear.weight` (transposed), `params/out/bias` becomes
`out.bias`, and an `Embedding`'s `params/<name>/table` (the skip-gram
and KG tables, TransX's projections) becomes `<name>.table` as it is. A checkpoint holds the leaves in flax's tree_flatten order
(sorted keys) and the optimizer state in optax's leaf order, so either
package restores what the other saved.
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


def _flax_path(key: str) -> tuple:
    """The inverse of `_torch_key`: `net.gnn.convs.0.linear.weight` →
    (net, gnn, convs_0, Dense_0, kernel)."""
    parts = key.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "convs" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"convs_{parts[i + 1]}")
            i += 2
            continue
        out.append({"linear": "Dense_0", "weight": "kernel"}.get(parts[i], parts[i]))
        i += 1
    return tuple(out)


def checkpoint_order(keys) -> list[str]:
    """state_dict keys in the order of their flax leaves."""
    return [k for _, k in sorted((_flax_path(k), k) for k in keys)]


def to_flax_leaf(key: str, t: torch.Tensor) -> np.ndarray:
    """One state_dict entry (or a tensor shaped like it) as the flax leaf
    (f32 numpy; Linear weights transposed to kernels)."""
    a = t.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(a.T) if _flax_path(key)[-1] == "kernel" else a.copy()


def from_flax_leaf(key: str, leaf) -> torch.Tensor:
    a = np.array(leaf, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(a.T) if _flax_path(key)[-1] == "kernel" else a)


def to_checkpoint_leaves(state_dict) -> list[np.ndarray]:
    """The inverse of `from_checkpoint_leaves`: the state_dict as flax
    param leaves in tree_flatten order."""
    return [to_flax_leaf(k, state_dict[k]) for k in checkpoint_order(state_dict)]


# per optimizer: the torch state slot behind each optax leaf group, in
# optax's order (adam's int32 `count` leaf leads; sgd has no state)
OPTAX_SLOTS = {
    "adam": ("exp_avg", "exp_avg_sq"),
    "adagrad": ("sum",),
    "sgd": (),
    "momentum": ("momentum_buffer",),
}
# the value a slot starts from in optax before the first update
_SLOT_INIT = {"exp_avg": 0.0, "exp_avg_sq": 0.0, "sum": 0.1, "momentum_buffer": 0.0}


def optimizer_leaves(name: str, optimizer, named_params: dict) -> list[np.ndarray]:
    """The torch optimizer's state as optax's leaves for optimizer `name`
    (adam: count, mu leaves, nu leaves; adagrad: sum of squares;
    momentum: trace; sgd: none), each group in flax leaf order. Slots not
    created yet (before the first step) are their optax init values."""
    keys = checkpoint_order(named_params)
    leaves = []
    if name == "adam":
        st = optimizer.state.get(named_params[keys[0]], {})
        leaves.append(np.asarray(int(st.get("step", 0)), np.int32))
    for slot in OPTAX_SLOTS[name]:
        for k in keys:
            p = named_params[k]
            t = optimizer.state.get(p, {}).get(slot)
            if t is None:
                t = torch.full_like(p, _SLOT_INIT[slot])
            leaves.append(to_flax_leaf(k, t))
    return leaves


def load_optimizer_leaves(name: str, optimizer, named_params: dict, leaves) -> None:
    """Set the torch optimizer's state from optax's leaves (the inverse
    of `optimizer_leaves`)."""
    keys = checkpoint_order(named_params)
    leaves = list(leaves)
    want = (name == "adam") + len(OPTAX_SLOTS[name]) * len(keys)
    if len(leaves) != want:
        raise ValueError(
            f"{name} state needs {want} leaves for {len(keys)} params, got {len(leaves)}"
        )
    step = None
    if name == "adam":
        step = torch.tensor(float(np.asarray(leaves.pop(0))), dtype=torch.float32)
    for i, slot in enumerate(OPTAX_SLOTS[name]):
        for j, k in enumerate(keys):
            p = named_params[k]
            st = optimizer.state[p]
            st[slot] = from_flax_leaf(k, leaves[i * len(keys) + j]).to(p.device)
            if step is not None:
                # a capturable Adam keeps its step count on the param's device
                capturable = optimizer.param_groups[0].get("capturable", False)
                st["step"] = step.clone().to(p.device if capturable else "cpu")


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Re-initialise every nn.Linear of `model` the way flax's Dense does
    by default (lecun_normal kernel: truncated normal at ±2σ, σ =
    sqrt(1/fan_in)/0.8796…; zero bias) and every `Embedding` table from
    its row init (normal(0.02), or the KG projections' identity and
    zeros), drawing from `generator`. Returns the model's state_dict."""
    from euler_tpu_torch.nn.encoders import Embedding

    for m in model.modules():
        if isinstance(m, Embedding):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(
                m.weight, std=std, a=-2 * std, b=2 * std, generator=generator
            )
            if m.bias is not None:
                m.bias.zero_()
    return model.state_dict()
