"""ctypes binding for the native C++ graph engine, `cpp/graph_engine.cc`
(counterpart: euler_tpu/graph/native.py).

`build_engine()` compiles the engine with the host compiler into
`euler_tpu_torch/_build/graph_engine-<hash>/` (`ops._build.build_host`:
the hash covers the source, the flags and the compiler's version; the
build holds a file lock and renames a finished temporary file into
place); a failed build raises. The port never reads or writes a library
beside the source.

`NativeGraphStore` is a `GraphStore` whose hot queries run in C++ over
the shard's tensor dir, which the engine maps itself: id lookup, root,
edge and neighbor sampling, degrees, the full adjacency, dense features
and the fused multi-hop fanout. A ctypes call releases the interpreter
lock, so batch-building threads sample in parallel. Each call draws one
seed from the caller's numpy Generator (`_seed`), as the JAX binding
does, so one Generator gives both packages the same draws. Within a call
the engine splits the work over `std::thread::hardware_concurrency()`
threads and seeds each chunk from its start, so a seed's draws are the
same on one machine and may differ between machines with other core
counts.

The random walk is bound for unbiased walks; a node2vec-biased walk (p
or q != 1) runs the numpy store's path, as in the JAX package. The
layer-wise (LADIES) draw is one engine call. Not bound yet: the
variable-length and binary feature calls, which no ported module calls.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from euler_tpu_torch.graph.meta import GraphMeta
from euler_tpu_torch.graph.store import GraphStore, split_hops
from euler_tpu_torch.ops import _build

ENGINE_SOURCE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "cpp", "graph_engine.cc")
)

# per-op counters exported by the engine (the Op enum's order in
# graph_engine.cc)
STAT_OPS = (
    "lookup",
    "sample_node",
    "sample_edge",
    "sample_neighbor",
    "get_dense",
    "random_walk",
    "sample_fanout",
    "full_neighbor",
    "degree_sum",
    "varlen_feature",
    "layerwise",
)

_c = ctypes
_u64p, _i64p = _c.POINTER(_c.c_uint64), _c.POINTER(_c.c_int64)
_i32p, _f32p, _u8p = _c.POINTER(_c.c_int32), _c.POINTER(_c.c_float), _c.POINTER(_c.c_uint8)
_h, _i64, _i32, _u64, _u8 = _c.c_void_p, _c.c_int64, _c.c_int32, _c.c_uint64, _c.c_uint8

# the bound engine calls: (name, restype, argtypes)
_SIGNATURES = (
    ("etpu_load", _h, [_c.c_char_p, _i64, _i64]),
    ("etpu_free", None, [_h]),
    ("etpu_lookup", None, [_h, _u64p, _i64, _i64p]),
    ("etpu_sample_node", None, [_h, _i64, _i32, _u64, _u64p]),
    ("etpu_sample_edge", None, [_h, _i64, _i32, _u64, _u64p]),
    ("etpu_sample_neighbor_dir", None,
     [_h, _u64p, _i64, _i32p, _i64, _i64, _u8, _u64, _u64p, _f32p, _i32p, _u8p, _i64p]),
    ("etpu_sample_neighbor_rows", None,
     [_h, _u64p, _i64, _i32p, _i64, _i64, _u64, _u64p, _u8p, _i64p]),
    ("etpu_degree_sum", None, [_h, _u64p, _i64, _i32p, _i64, _u8, _i64p]),
    ("etpu_full_neighbor", None,
     [_h, _u64p, _i64, _i32p, _i64, _i64, _u8, _i32, _u64p, _f32p, _i32p, _u8p, _i64p]),
    ("etpu_get_dense", None, [_h, _u64p, _i64, _i64, _i64, _f32p]),
    ("etpu_get_dense_rows", None, [_h, _i64p, _i64, _i64, _i64, _f32p]),
    ("etpu_sample_fanout", None,
     [_h, _u64p, _i64, _i32p, _i64, _i64p, _i64, _u64, _u64p, _i64p, _f32p, _i32p, _u8p]),
    ("etpu_random_walk", None, [_h, _u64p, _i64, _i32p, _i64, _i64, _u64, _u64p]),
    ("etpu_layerwise", None, [_h, _u64p, _i64, _i32p, _i64, _i64, _u64, _u64p, _f32p, _u8p]),
    ("etpu_stats", None, [_h, _u64p]),
    ("etpu_reset_stats", None, [_h]),
)

_lib = None
_lib_lock = threading.Lock()


def build_engine(source: str = ENGINE_SOURCE, cxx: str | None = None) -> str:
    """Compile the engine (unless built) into the port's build directory;
    returns the library's path. Raises when the compiler fails."""
    return _build.build_host("graph_engine", source, cxx)


def engine_available() -> bool:
    """True when the engine is loaded or a host C++ compiler is there to
    build it (`Graph.load(native=None)` then uses it, and a build that
    fails raises)."""
    return _lib is not None or shutil.which(os.environ.get("CXX") or "g++") is not None


def _load_lib() -> ctypes.CDLL:
    """The engine, built and bound once a process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_engine())
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as_ids(ids) -> np.ndarray:
    return np.ascontiguousarray(ids, dtype=np.uint64)


def _types_arr(edge_types) -> np.ndarray:
    return np.ascontiguousarray([] if edge_types is None else list(edge_types), dtype=np.int32)


class NativeGraphStore(GraphStore):
    """A GraphStore whose hot paths run in the C++ engine: the shard's
    arrays are read twice, as numpy views (the cold paths and feature
    metadata) and by the engine from `directory`."""

    def __init__(self, meta: GraphMeta, arrays, part: int, directory: str):
        super().__init__(meta, arrays, part)
        self._lib = _load_lib()
        self._h = self._lib.etpu_load(directory.encode(), meta.num_node_types,
                                      meta.num_edge_types)
        if not self._h:
            raise RuntimeError(f"native engine failed to load {directory}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.etpu_free(self._h)
            self._h = None

    def _seed(self, rng) -> int:
        """One engine seed from the caller's Generator (one draw a call)."""
        if rng is None:
            rng = np.random.default_rng()
        return int(rng.integers(0, 2**63 - 1))

    def lookup(self, ids):
        ids = _as_ids(ids)
        rows = np.empty(len(ids), dtype=np.int64)
        self._lib.etpu_lookup(self._h, _ptr(ids, _c.c_uint64), len(ids), _ptr(rows, _c.c_int64))
        return rows

    def sample_node(self, count, node_type=-1, rng=None):
        out = np.empty(count, dtype=np.uint64)
        self._lib.etpu_sample_node(self._h, count, node_type, self._seed(rng),
                                   _ptr(out, _c.c_uint64))
        return out

    def sample_edge(self, count, edge_type=-1, rng=None):
        """[count, 3] u64 rows of (src, dst, type)."""
        out = np.empty((count, 3), dtype=np.uint64)
        self._lib.etpu_sample_edge(self._h, count, edge_type, self._seed(rng),
                                   _ptr(out, _c.c_uint64))
        return out

    def sample_neighbor(self, ids, edge_types=None, count=10, rng=None):
        ids, types = _as_ids(ids), _types_arr(edge_types)
        n = len(ids)
        nbr = np.empty((n, count), dtype=np.uint64)
        w = np.empty((n, count), dtype=np.float32)
        tt = np.empty((n, count), dtype=np.int32)
        mask = np.empty((n, count), dtype=np.uint8)
        eidx = np.empty((n, count), dtype=np.int64)
        self._lib.etpu_sample_neighbor_dir(
            self._h, _ptr(ids, _c.c_uint64), n, _ptr(types, _c.c_int32), len(types), count,
            0, self._seed(rng), _ptr(nbr, _c.c_uint64), _ptr(w, _c.c_float),
            _ptr(tt, _c.c_int32), _ptr(mask, _c.c_uint8), _ptr(eidx, _c.c_int64))
        return nbr, w, tt, mask.astype(bool), eidx

    def sample_neighbor_rows(self, ids, edge_types=None, count=10, rng=None):
        """Lean draw: (nbr, mask, local rows of the picked dsts, -1 where a
        dst lives on another shard)."""
        ids, types = _as_ids(ids), _types_arr(edge_types)
        n = len(ids)
        nbr = np.empty((n, count), dtype=np.uint64)
        mask = np.empty((n, count), dtype=np.uint8)
        rows = np.empty((n, count), dtype=np.int64)
        self._lib.etpu_sample_neighbor_rows(
            self._h, _ptr(ids, _c.c_uint64), n, _ptr(types, _c.c_int32), len(types), count,
            self._seed(rng), _ptr(nbr, _c.c_uint64), _ptr(mask, _c.c_uint8),
            _ptr(rows, _c.c_int64))
        return nbr, mask.astype(bool), rows

    def degree_sum(self, ids, edge_types=None):
        ids, types = _as_ids(ids), _types_arr(edge_types)
        out = np.empty(len(ids), dtype=np.int64)
        self._lib.etpu_degree_sum(self._h, _ptr(ids, _c.c_uint64), len(ids),
                                  _ptr(types, _c.c_int32), len(types), 0, _ptr(out, _c.c_int64))
        return out

    def get_full_neighbor(self, ids, edge_types=None, max_degree=None, *, sort_by=None):
        """Padded full adjacency; sort_by None (storage order), "id" or
        "weight" (descending), sorted per row inside the engine."""
        ids, types = _as_ids(ids), _types_arr(edge_types)
        n = len(ids)
        if max_degree is None:
            cap = int(self.degree_sum(ids, edge_types).max(initial=0))
        else:
            cap = int(max_degree)
        cap = max(cap, 1)
        sort_mode = {None: 0, "id": 1, "weight": 2}[sort_by]
        nbr = np.empty((n, cap), dtype=np.uint64)
        w = np.empty((n, cap), dtype=np.float32)
        tt = np.empty((n, cap), dtype=np.int32)
        mask = np.empty((n, cap), dtype=np.uint8)
        eidx = np.empty((n, cap), dtype=np.int64)
        self._lib.etpu_full_neighbor(
            self._h, _ptr(ids, _c.c_uint64), n, _ptr(types, _c.c_int32), len(types), cap, 0,
            sort_mode, _ptr(nbr, _c.c_uint64), _ptr(w, _c.c_float), _ptr(tt, _c.c_int32),
            _ptr(mask, _c.c_uint8), _ptr(eidx, _c.c_int64))
        return nbr, w, tt, mask.astype(bool), eidx

    def _dense(self, fn, keys, ctype, names) -> np.ndarray:
        cols = []
        for nm in names:
            spec = self.meta.feature_spec(nm, node=True)
            out = np.empty((len(keys), spec.dim), dtype=np.float32)
            fn(self._h, _ptr(keys, ctype), len(keys), spec.fid, spec.dim,
               _ptr(out, _c.c_float))
            cols.append(out)
        return np.concatenate(cols, axis=1) if cols else np.zeros((len(keys), 0), np.float32)

    def get_dense_feature(self, ids, names):
        return self._dense(self._lib.etpu_get_dense, _as_ids(ids), _c.c_uint64, names)

    def get_dense_by_rows(self, rows, names):
        """Dense features by pre-resolved local rows (-1 → zeros)."""
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        return self._dense(self._lib.etpu_get_dense_rows, rows, _c.c_int64, names)

    def fanout_with_rows(self, ids, edge_types, counts, rng=None):
        """The fused multi-hop fanout in one engine call: (hop_ids, hop_w,
        hop_tt, hop_mask, hop_rows), lists over hops 0..len(counts), hop i
        flat with len(ids) * prod(counts[:i]) entries; hop_rows are local
        store rows (-1 invalid)."""
        ids, types = _as_ids(ids), _types_arr(edge_types)
        n = len(ids)
        counts_arr = np.ascontiguousarray(counts, dtype=np.int64)
        total, width = n, n
        for c in counts:
            width *= int(c)
            total += width
        ids_out = np.empty(total, dtype=np.uint64)
        rows_out = np.empty(total, dtype=np.int64)
        w_out = np.empty(total, dtype=np.float32)
        tt_out = np.empty(total, dtype=np.int32)
        mask_out = np.empty(total, dtype=np.uint8)
        self._lib.etpu_sample_fanout(
            self._h, _ptr(ids, _c.c_uint64), n, _ptr(types, _c.c_int32), len(types),
            _ptr(counts_arr, _c.c_int64), len(counts), self._seed(rng),
            _ptr(ids_out, _c.c_uint64), _ptr(rows_out, _c.c_int64), _ptr(w_out, _c.c_float),
            _ptr(tt_out, _c.c_int32), _ptr(mask_out, _c.c_uint8))
        ids_h, w_h, tt_h, mask_h, rows_h = split_hops(
            n, counts, ids_out, w_out, tt_out, mask_out, rows_out)
        return ids_h, w_h, tt_h, [m.astype(bool) for m in mask_h], rows_h

    def random_walk(self, ids, edge_types=None, walk_len=3, p=1.0, q=1.0, rng=None):
        """u64 [n, walk_len+1] walks in one engine call; a node2vec bias
        (p or q != 1) takes the numpy store's path."""
        if p != 1.0 or q != 1.0:
            return super().random_walk(ids, edge_types, walk_len, p, q, rng)
        ids, types = _as_ids(ids), _types_arr(edge_types)
        out = np.empty((len(ids), walk_len + 1), dtype=np.uint64)
        self._lib.etpu_random_walk(
            self._h, _ptr(ids, _c.c_uint64), len(ids), _ptr(types, _c.c_int32), len(types),
            walk_len, self._seed(rng), _ptr(out, _c.c_uint64))
        return out

    def sample_neighbor_layerwise(self, batch_ids, edge_types=None, count=128, rng=None):
        """The layer-wise draw in one engine call: (layer_ids u64[count],
        adj f32[n, count], mask bool[count])."""
        ids, types = _as_ids(batch_ids), _types_arr(edge_types)
        n = len(ids)
        layer = np.empty(count, dtype=np.uint64)
        adj = np.empty((n, count), dtype=np.float32)
        lmask = np.empty(count, dtype=np.uint8)
        self._lib.etpu_layerwise(
            self._h, _ptr(ids, _c.c_uint64), n, _ptr(types, _c.c_int32), len(types), count,
            self._seed(rng), _ptr(layer, _c.c_uint64), _ptr(adj, _c.c_float),
            _ptr(lmask, _c.c_uint8))
        return layer, adj, lmask.astype(bool)

    def op_stats(self) -> dict:
        """Per-op {"calls", "ms"} counters of the engine."""
        out = np.zeros(2 * len(STAT_OPS), dtype=np.uint64)
        self._lib.etpu_stats(self._h, _ptr(out, _c.c_uint64))
        k = len(STAT_OPS)
        return {name: {"calls": int(out[i]), "ms": float(out[k + i]) / 1e6}
                for i, name in enumerate(STAT_OPS)}

    def reset_op_stats(self) -> None:
        self._lib.etpu_reset_stats(self._h)
