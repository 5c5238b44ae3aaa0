"""Tensor-dir binary format (counterpart: euler_tpu/graph/format.py).

A *tensor dir* holds `tensors.bin` (the raw little-endian arrays, each
64-byte aligned), `tensors.idx` (a binary index) and `tensors.json` (the
same index as JSON). The port reads and writes the same bytes as the JAX
package, so a graph dir or a checkpoint written by either is read by both.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

MAGIC = b"EULRTPU1"
ALIGN = 64

# stable dtype codes shared with the JAX package and its C++ engine
_DTYPE_CODES = {
    np.dtype(np.uint8): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.uint64): 4,
    np.dtype(np.float32): 5,
    np.dtype(np.float64): 6,
    np.dtype(np.uint32): 7,
}
try:  # bfloat16 rides the wire for weighted lean minibatches; the C++
    # engine never stores it, so the code is wire-only
    import ml_dtypes

    _DTYPE_CODES[np.dtype(ml_dtypes.bfloat16)] = 8
except ImportError:  # the port itself never builds a numpy bf16 array
    pass
# the inverse table the wire decoder reads
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_arrays(
    path: str, arrays: dict[str, np.ndarray], fsync: bool = False
) -> None:
    """Write `arrays` as a tensor dir at `path` (created if needed);
    `fsync=True` flushes every file to stable storage before returning."""
    os.makedirs(path, exist_ok=True)
    index = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {arr.dtype} for array {name!r}")
        index.append(
            {
                "name": name,
                "dtype": str(arr.dtype),
                "code": _DTYPE_CODES[arr.dtype],
                "shape": list(arr.shape),
                "offset": offset,
                "nbytes": arr.nbytes,
            }
        )
        offset = _align(offset + arr.nbytes)

    with open(os.path.join(path, "tensors.bin"), "wb") as f:
        for meta, arr in zip(index, arrays.values()):
            f.seek(meta["offset"])
            f.write(np.ascontiguousarray(arr).tobytes())
        if fsync:
            f.flush()
            os.fsync(f.fileno())

    with open(os.path.join(path, "tensors.idx"), "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<q", len(index)))
        for meta in index:
            name_b = meta["name"].encode()
            f.write(struct.pack("<i", len(name_b)))
            f.write(name_b)
            f.write(struct.pack("<BB", meta["code"], len(meta["shape"])))
            for d in meta["shape"]:
                f.write(struct.pack("<q", d))
            f.write(struct.pack("<qq", meta["offset"], meta["nbytes"]))
        if fsync:
            f.flush()
            os.fsync(f.fileno())

    with open(os.path.join(path, "tensors.json"), "w") as f:
        json.dump({"version": 1, "arrays": index}, f, indent=1)
        if fsync:
            f.flush()
            os.fsync(f.fileno())


def read_arrays(path: str, mmap: bool = True) -> dict[str, np.ndarray]:
    """Read a tensor dir into {name: ndarray}; memory-maps by default."""
    with open(os.path.join(path, "tensors.json")) as f:
        index = json.load(f)["arrays"]
    bin_path = os.path.join(path, "tensors.bin")
    if mmap:
        buf = np.memmap(bin_path, dtype=np.uint8, mode="r")
    else:
        buf = np.fromfile(bin_path, dtype=np.uint8)
    out: dict[str, np.ndarray] = {}
    for meta in index:
        dt = np.dtype(meta["dtype"])
        raw = buf[meta["offset"] : meta["offset"] + meta["nbytes"]]
        out[meta["name"]] = raw.view(dt).reshape(meta["shape"])
    return out
