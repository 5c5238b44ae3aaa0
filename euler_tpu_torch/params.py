"""Weights and optimizer state carried between the packages, and a
seeded init.

A flax Dense keeps `kernel` [in, out] and `bias` [out]; a torch
nn.Linear keeps `weight` [out, in] and `bias` [out]. Module paths map
one to one: `params/net/gnn/convs_<i>/Dense_0/kernel` becomes
`net.gnn.convs.<i>.linear.weight` (transposed), a conv's `Dense_<j>`
for j > 0 its `linear_<j>`, `Conv_<j>` its `conv` / `conv_<j>` (a flax
Conv kernel [k, in, out] is a Conv1d weight [out, in, k]: the axes
reversed), `LSTMCell_0` / `GRUCell_0` its `lstm` / `gru` (whose gate
Denses `ii`, `hr`, ... keep flax's names), `params/out/bias` becomes
`out.bias`, and every other name — an `Embedding`'s
`params/<name>/table` (the skip-gram and KG tables, TransX's
projections), GAT's `att_src` / `att_dst`, GIN's `eps`, AGNN's `beta`,
GeniePath's `carry_c`, GraphClassifier's `pooler` and `head`,
RelationConv's `basis` / `coef` / `rel_w`, DGI's `bilinear`, GAE's
`encoder` / `mu_head` / `logvar_head`, LayerwiseGCN's `denses_<l>` /
`self_denses_<l>` — keeps its name and its shape. A checkpoint holds the leaves in flax's tree_flatten order
(sorted keys) and the optimizer state in optax's leaf order, so either
package restores what the other saved.
"""

from __future__ import annotations

import hashlib
import math
import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


# flax's auto-named module types and the port's attribute for each: the
# first is `<attr>`, the j-th `<attr>_<j>`
_MODULE_ATTRS = {"Dense": "linear", "Conv": "conv", "LSTMCell": "lstm", "GRUCell": "gru"}
_ATTR_MODULES = {v: k for k, v in _MODULE_ATTRS.items()}


def _torch_key(path: tuple) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"convs_(\d+)", p)
        auto = re.fullmatch(r"([A-Za-z]+)_(\d+)", p)
        if m:
            parts += ["convs", m.group(1)]
        elif auto and auto.group(1) in _MODULE_ATTRS:
            attr, j = _MODULE_ATTRS[auto.group(1)], auto.group(2)
            parts.append(attr if j == "0" else f"{attr}_{j}")
        elif p == "kernel":
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def _kernel_to_torch(a: np.ndarray, path) -> np.ndarray:
    """A flax kernel as the torch weight: [in, out] -> [out, in], [k, in,
    out] -> [out, in, k] (both the axes reversed)."""
    if a.ndim not in (2, 3):
        raise ValueError(f"{'/'.join(path)}: kernel must be 2-D or 3-D, got {a.shape}")
    return np.ascontiguousarray(a.T)


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
    numpy arrays or anything `np.asarray` reads, or boxes with an
    `unbox()` (flax's `nn.Partitioned`, around the id tables)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, leaf in _leaves(tree):
        if hasattr(leaf, "unbox"):
            leaf = leaf.unbox()
        a = np.array(leaf, dtype=np.float32)  # a writable copy
        if path[-1] == "kernel":
            a = _kernel_to_torch(a, path)
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
    (net, gnn, convs_0, Dense_0, kernel); `linear_<j>` → `Dense_<j>`,
    `conv`, `lstm`, `gru` → `Conv_0`, `LSTMCell_0`, `GRUCell_0`."""
    parts = key.split(".")
    out, i = [], 0
    while i < len(parts):
        if parts[i] == "convs" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"convs_{parts[i + 1]}")
            i += 2
            continue
        m = re.fullmatch(r"([a-z]+)(?:_(\d+))?", parts[i])
        if m and m.group(1) in _ATTR_MODULES:
            out.append(f"{_ATTR_MODULES[m.group(1)]}_{m.group(2) or 0}")
        else:
            out.append("kernel" if parts[i] == "weight" else parts[i])
        i += 1
    return tuple(out)


def checkpoint_order(keys) -> list[str]:
    """state_dict keys in the order of their flax leaves."""
    return [k for _, k in sorted((_flax_path(k), k) for k in keys)]


def to_flax_leaf(key: str, t: torch.Tensor) -> np.ndarray:
    """One state_dict entry (or a tensor shaped like it) as the flax leaf
    (f32 numpy; Linear weights transposed to kernels)."""
    a = t.detach().to("cpu", torch.float32).numpy()
    # [out, in] -> [in, out]; a Conv1d's [out, in, k] -> [k, in, out]
    return np.ascontiguousarray(a.T) if _flax_path(key)[-1] == "kernel" else a.copy()


def from_flax_leaf(key: str, leaf) -> torch.Tensor:
    a = np.array(leaf, dtype=np.float32)
    path = _flax_path(key)
    return torch.from_numpy(_kernel_to_torch(a, path) if path[-1] == "kernel" else a)


def state_dict_from_leaves(state_dict, leaves) -> dict[str, torch.Tensor]:
    """A model's state_dict from a checkpoint's param leaves (either
    package's), matched to its keys in flax leaf order (`state_dict` the
    model's own, for its keys)."""
    keys = checkpoint_order(state_dict)
    leaves = list(leaves)
    if len(leaves) != len(keys):
        raise ValueError(
            f"checkpoint carries {len(leaves)} param leaves where the model has {len(keys)}"
        )
    return {k: from_flax_leaf(k, leaf) for k, leaf in zip(keys, leaves)}


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


# ---- flax's own init, drawn as JAX draws it ---------------------------------
#
# `flax_init` gives the params the JAX package's Estimator initialises a
# flax model with for a seed (euler_tpu/estimator/estimator.py:418-422:
# `model.init({"params": split(PRNGKey(seed), 1)[0]}, batch)`): JAX's
# threefry2x32 keys (jax._src.prng, `jax_threefry_partitionable` on),
# flax's per-param keys (the params key folded with the SHA-1 of the
# param's module path and its creation count in that module,
# flax/core/scope.py `_fold_in_static`) and lecun_normal's truncated normal
# (jax._src.random `_truncated_normal`: a uniform mapped through XLA's
# single-precision erf_inv). numpy rounds XLA's log1p inside erf_inv to
# another neighbour now and then (about 1 % of the draws), so a value may
# sit 1-3 ulp off flax's (3 seen once: a Dense kernel at seed 5).

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv for f32 (M. Giles, "Approximating the erfinv function"):
# the polynomial in w - 2.5 for w < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# a param's creation count in its flax module (`Scope.make_rng` counts from
# 1): Dense and Conv make kernel then bias, GATConv att_src then att_dst,
# RelationConv basis then coef (or rel_w alone; its Dense is a submodule)
_FLAX_PARAM_COUNT = {"kernel": 1, "bias": 2, "att_src": 1, "att_dst": 2, "eps": 1, "beta": 1,
                     "basis": 1, "coef": 2, "rel_w": 1, "bilinear": 1}
# the hidden-state Denses of flax's GRUCell and LSTMCell, whose kernels
# take `orthogonal()`
_RECURRENT = {"hr", "hz", "hn", "hi", "hf", "hg", "ho"}


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 under key."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key_words(key, n: int):
    """threefry2x32 of the counters 0..n-1 under key (a split's keys, or
    random bits' two words)."""
    return _threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def _fold_in(key, data: int):
    y0, y1 = _threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return y0[0], y1[0]


def _fold_in_path(key, suffix):
    """flax's `_fold_in_static`: fold the first 4 bytes (big-endian) of
    the SHA-1 of the suffix's strings and ints into key."""
    m = hashlib.sha1()
    for x in suffix:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return _fold_in(key, int.from_bytes(m.digest()[:4], "big"))


def _fma32(a, b, c) -> np.ndarray:
    """f32 a*b + c rounded once, as XLA fuses it (the f32 product is exact
    in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    # XLA's w = -log1p(-x·x), the square rounded to f32 first
    xx = (x * x).astype(np.float32)
    w = (-np.log1p(-xx.astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, w, np.where(lt, np.float32(lo), np.float32(hi)))
    return (p * x).astype(np.float32)


def _uniform(key, shape, lo, hi) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, lo, hi)."""
    n = int(np.prod(shape))
    b0, b1 = _key_words(key, n)
    bits = (b0 ^ b1).reshape(shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def _truncated_normal(key, shape) -> np.ndarray:
    """jax.random.truncated_normal(key, -2, 2, shape, float32)."""
    sqrt2 = np.float32(math.sqrt(2))
    lo = np.float32(math.erf(float(np.float32(-2) / sqrt2)))
    hi = np.float32(math.erf(float(np.float32(2) / sqrt2)))
    out = (sqrt2 * _erfinv32(_uniform(key, shape, lo, hi))).astype(np.float32)
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf)))


def _normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32): a uniform on (-1, 1) through
    erf_inv."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = _uniform(key, shape, lo, np.float32(1))
    return (np.float32(math.sqrt(2)) * _erfinv32(u)).astype(np.float32)


def _orthogonal(key, shape) -> np.ndarray:
    """jax.nn.initializers.orthogonal()(key, shape) for a 2-D kernel:
    jax.random.orthogonal's normal draw, its QR and the signs of R's
    diagonal. numpy factors in f64 where XLA factors in f32, so a value
    may differ from flax's by the f32 QR's rounding."""
    rows, cols = shape
    z = _normal(key, (max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(z.astype(np.float64))
    q = (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)
    return q.T if rows < cols else q


def flax_init(model: nn.Module, seed: int, *, raw_key: bool = False) -> dict[str, torch.Tensor]:
    """The state_dict of the params the JAX package's Estimator draws for
    the flax twin of `model` at `seed` (see the note above): every weight,
    Conv kernel, GAT attention vector, RelationConv `basis` / `rel_w` and
    DGI `bilinear` from lecun_normal (fan_in = the product of the flax
    shape's axes but the last: a Conv's k·in, a basis' B·in), RelationConv's
    `coef` from normal(0.1), the hidden-state kernels of the recurrent
    cells from `orthogonal()`, GIN's `eps` its owner's `eps_init`, AGNN's
    `beta` 1, every bias 0. Raises on any other param. (A model that
    declares rng_collections, like GAE, takes the params key from a wider
    split of the seed's key; with threefry partitionable its first key is
    the same.) raw_key=True takes `PRNGKey(seed)` itself as the params
    key, as `model.init(PRNGKey(seed), batch)` does (ScalableTrainer)."""
    if raw_key:
        key = (np.uint32(0), np.uint32(seed))
    else:
        k0, k1 = _key_words((np.uint32(0), np.uint32(seed)), 1)
        key = (k0[0], k1[0])
    out = {}
    for name, t in model.state_dict().items():
        path = _flax_path(name)
        kind = path[-1]
        if kind not in _FLAX_PARAM_COUNT:
            raise NotImplementedError(f"flax_init: no flax initializer known for {name}")
        shape = tuple(t.shape[::-1]) if kind == "kernel" else tuple(t.shape)
        pkey = _fold_in_path(key, path[:-1] + (_FLAX_PARAM_COUNT[kind],))
        if kind == "bias":
            leaf = np.zeros(shape, np.float32)
        elif kind == "eps":
            owner = model.get_submodule(name.rpartition(".")[0])
            leaf = np.full(shape, owner.eps_init, np.float32)
        elif kind == "beta":
            leaf = np.ones(shape, np.float32)
        elif kind == "coef":
            leaf = (_normal(pkey, shape) * np.float32(0.1)).astype(np.float32)
        elif kind == "kernel" and len(path) > 2 and path[-2] in _RECURRENT \
                and path[-3].split("_")[0] in ("LSTMCell", "GRUCell"):
            leaf = _orthogonal(pkey, shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
            leaf = (_truncated_normal(pkey, shape) * std).astype(np.float32)
        out[name] = from_flax_leaf(name, leaf)
    return out


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Re-initialise every nn.Linear of `model` the way flax's Dense does
    by default (lecun_normal kernel: truncated normal at ±2σ, σ =
    sqrt(1/fan_in)/0.8796…; zero bias), every Conv1d as flax's Conv
    (lecun_normal, fan_in = k·in; zero bias), every `Embedding` table from
    its row init (normal(0.02), or the KG projections' identity and zeros)
    and every module's own flax-initialised params (`reset_like_flax`:
    GAT's attention vectors, GIN's eps, AGNN's beta, a recurrent cell's
    whole tree), drawing from `generator` in module order. Returns the
    model's state_dict."""
    from euler_tpu_torch.layers.conv import lecun_normal_
    from euler_tpu_torch.nn.encoders import Embedding

    owned = set()  # the submodules of a cell, which its reset_like_flax drew
    for m in model.modules():
        if id(m) in owned:
            continue
        if isinstance(m, Embedding):
            m.reset_parameters(generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.in_features if isinstance(m, nn.Linear) else m.in_channels * m.kernel_size[0]
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "reset_like_flax"):
            m.reset_like_flax(generator)
            if getattr(m, "resets_subtree", False):
                owned.update(id(c) for c in m.modules())
    return model.state_dict()
