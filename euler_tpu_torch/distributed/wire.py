"""Wire protocol for the graph service: length-prefixed binary frames
(counterpart: euler_tpu/distributed/wire.py, copied whole: the frames are
byte-identical to the JAX package's).

Replaces the reference's TensorProto-over-gRPC encoding
(euler/core/framework/tensor_util.h, proto/worker.proto:137-152) with a
minimal self-describing format — no proto toolchain needed, arrays travel as
raw little-endian buffers, and the C++ engine could emit the same frames.

Frame:   [u32 payload_len][payload]
Payload: [u16 op_len][op utf8][u16 n_values][value...]
Value:   [u8 tag] + tag-specific body
  0 array: [u8 dtype_code][u8 ndim][i64 shape...]["raw bytes"]
  1 int:   [i64]
  2 float: [f64]
  3 str:   [u32 len][utf8]
  4 none:  —
  5 bool:  [u8]
  6 list of values: [u16 n][value...]

Deadline propagation rides the op string, not the frame layout: a call
with a time budget ships op "@dl:<remaining_ms>:<op>" (see
`wrap_deadline`/`unwrap_deadline`). The budget is RELATIVE milliseconds —
client and server clocks are never compared — and servers reject
already-expired work with a typed err frame before dispatch. A server that
predates the envelope answers the envelope with "unknown op '@dl:...'", which clients
treat as a degrade signal: drop the envelope for that shard and resend
(deadlines then only bound the client side). Frame layout is untouched,
so every other verb stays byte-compatible in both directions.

Zero-copy I/O discipline (the hot-path contract):

- send: `encode_vectored` keeps large array payloads as memoryviews of
  the source arrays and `send_frame` scatter-gathers them with
  `sendmsg`, so a multi-MB feature block is never copied into a staging
  buffer; small values coalesce into one header buffer whose first four
  bytes are the length prefix (packed in place — no header + payload
  concatenation copy).
- recv: `_read_exact` recv_into's ONE exact-size bytearray (no chunk
  list, no b"".join copy, no 1 MiB recv cap forcing extra syscalls on
  multi-MB frames).
- decode: `borrow=True` makes decoded arrays SLICE the frame buffer
  instead of copying it. Safe because every frame gets a fresh buffer
  that nothing mutates; consumers that retain per-id blocks (the client
  read cache) copy just the rows they keep, so a few cached rows never
  pin a whole frame.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

from euler_tpu_torch.graph.format import _CODE_DTYPES, _DTYPE_CODES

MAX_FRAME = 1 << 31

DEADLINE_PREFIX = "@dl:"


def wrap_deadline(op: str, budget_ms: float) -> str:
    """Envelope `op` with a remaining-time budget in milliseconds."""
    return f"{DEADLINE_PREFIX}{budget_ms:.1f}:{op}"


def unwrap_deadline(op: str) -> tuple[str, float | None]:
    """(inner op, remaining budget ms) — (op, None) when no envelope."""
    if not op.startswith(DEADLINE_PREFIX):
        return op, None
    _, ms, inner = op.split(":", 2)
    return inner, float(ms)


# arrays at least this big ride as their own iovec in the vectored
# encode (below it, appending to the header buffer beats iovec overhead)
_VECTOR_MIN_BYTES = 4096


def _tail(parts: list) -> bytearray:
    """The bytearray small values accumulate into — a fresh one after
    every zero-copy iovec so wire order is preserved."""
    if not isinstance(parts[-1], bytearray):
        parts.append(bytearray())
    return parts[-1]


def _pack_value(parts: list, v, vectored: bool) -> None:
    buf = _tail(parts)
    if isinstance(v, np.ndarray):
        v = np.ascontiguousarray(v)
        if v.dtype == np.bool_:
            v = v.astype(np.uint8)
        buf += struct.pack("<BBB", 0, _DTYPE_CODES[v.dtype], v.ndim)
        for d in v.shape:
            buf += struct.pack("<q", d)
        if vectored and v.nbytes >= _VECTOR_MIN_BYTES:
            # zero-copy: the array's own buffer becomes an iovec; the
            # memoryview keeps the (contiguous) source alive until sent
            parts.append(memoryview(v.reshape(-1).view(np.uint8)))
        else:
            buf += v.tobytes()
    elif isinstance(v, bool):
        buf += struct.pack("<BB", 5, int(v))
    elif isinstance(v, (int, np.integer)):
        buf += struct.pack("<Bq", 1, int(v))
    elif isinstance(v, (float, np.floating)):
        buf += struct.pack("<Bd", 2, float(v))
    elif isinstance(v, str):
        raw = v.encode()
        buf += struct.pack("<BI", 3, len(raw))
        buf += raw
    elif v is None:
        buf += struct.pack("<B", 4)
    elif isinstance(v, (list, tuple)):
        buf += struct.pack("<BH", 6, len(v))
        for item in v:
            _pack_value(parts, item, vectored)
    else:
        raise TypeError(f"cannot encode {type(v)}")


def _unpack_value(view: memoryview, off: int, borrow: bool = False):
    (tag,) = struct.unpack_from("<B", view, off)
    off += 1
    if tag == 0:
        code, ndim = struct.unpack_from("<BB", view, off)
        off += 2
        # hot path (every array of every RPC and WAL record): one
        # unpack for all dims, plain-int product (np.prod dominated
        # decode cost), and no frombuffer/copy churn for empty arrays
        if ndim:
            shape = struct.unpack_from("<%dq" % ndim, view, off)
            off += 8 * ndim
            n = 1
            for d in shape:
                n *= d
        else:
            shape, n = (), 1
        dt = _CODE_DTYPES[code]
        nbytes = dt.itemsize * n
        if n == 0:
            return np.empty(shape, dt), off + nbytes
        arr = np.frombuffer(view[off : off + nbytes], dtype=dt)
        if not borrow:
            arr = arr.copy()
        if ndim != 1:
            arr = arr.reshape(shape)
        return arr, off + nbytes
    if tag == 1:
        (v,) = struct.unpack_from("<q", view, off)
        return int(v), off + 8
    if tag == 2:
        (v,) = struct.unpack_from("<d", view, off)
        return float(v), off + 8
    if tag == 3:
        (n,) = struct.unpack_from("<I", view, off)
        off += 4
        return bytes(view[off : off + n]).decode(), off + n
    if tag == 4:
        return None, off
    if tag == 5:
        (v,) = struct.unpack_from("<B", view, off)
        return bool(v), off + 1
    if tag == 6:
        (n,) = struct.unpack_from("<H", view, off)
        off += 2
        items = []
        for _ in range(n):
            item, off = _unpack_value(view, off, borrow)
            items.append(item)
        return items, off
    raise ValueError(f"bad tag {tag}")


def _encode_parts(op: str, values, vectored: bool) -> list:
    head = bytearray(4)  # length-prefix placeholder, packed in place
    parts: list = [head]
    raw = op.encode()
    head += struct.pack("<H", len(raw))
    head += raw
    head += struct.pack("<H", len(values))
    for v in values:
        _pack_value(parts, v, vectored)
    total = sum(len(p) for p in parts) - 4
    if total > MAX_FRAME:
        raise ValueError(f"frame too large: {total}")
    struct.pack_into("<I", head, 0, total)
    return parts


def encode(op: str, values) -> bytearray:
    """One flat frame (length prefix included). Built in place — no
    header + payload concatenation copy."""
    parts = _encode_parts(op, values, vectored=False)
    return parts[0]  # vectored=False keeps everything in the head buffer


def encode_vectored(op: str, values) -> list:
    """Frame as an ordered buffer list for sendmsg scatter-gather: large
    arrays stay views of their source buffers (zero copies), small values
    coalesce around them. `b"".join(parts)` equals `encode(op, values)`."""
    return _encode_parts(op, values, vectored=True)


def decode(payload, borrow: bool = False) -> tuple[str, list]:
    # any malformed payload (truncated, corrupted, garbage) surfaces as
    # ValueError — ONE exception type for "this frame is broken", which
    # clients treat as a transport fault (failover) and servers as a
    # connection-costing error, never a hang or a dead worker.
    # borrow=True: decoded arrays are views of `payload` (no copy) —
    # callers must hand each frame its own buffer and never mutate it.
    try:
        return _decode(payload, borrow)
    except ValueError:
        raise
    except (struct.error, IndexError, UnicodeDecodeError, KeyError) as e:
        raise ValueError(f"malformed frame: {type(e).__name__}: {e}") from e


def _decode(payload, borrow: bool) -> tuple[str, list]:
    view = memoryview(payload)
    (op_len,) = struct.unpack_from("<H", view, 0)
    off = 2
    op = bytes(view[off : off + op_len]).decode()
    off += op_len
    (n,) = struct.unpack_from("<H", view, off)
    off += 2
    values = []
    for _ in range(n):
        v, off = _unpack_value(view, off, borrow)
        values.append(v)
    return op, values


def frame_nbytes(data) -> int:
    """Total wire bytes of one frame — flat buffer or `encode_vectored`
    part list (the per-verb bytes_in/bytes_out counter seam; counting
    here keeps the zero-copy send path free of a join)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return len(data)
    return sum(len(p) for p in data)


def read_frame(sock: socket.socket) -> bytearray | None:
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack("<I", header)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return _read_exact(sock, n)


def _read_exact(sock: socket.socket, n: int) -> bytearray | None:
    """Read exactly n bytes into ONE exact-size buffer via recv_into —
    no per-chunk allocations, no b"".join copy, and no artificial recv
    cap adding syscalls on multi-MB frames. The buffer is fresh per
    frame, which is what makes decode's borrow mode safe. None on EOF
    (clean between frames, torn mid-frame — callers treat both as a
    transport fault)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return None
        got += r
    return buf


def send_frame(sock: socket.socket, data) -> None:
    """Send one frame: flat bytes-like, or an `encode_vectored` buffer
    list scatter-gathered through sendmsg (sequential sendall where
    sendmsg is unavailable). Partial sendmsg results are resumed."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        sock.sendall(data)
        return
    bufs = [memoryview(p).cast("B") for p in data if len(p)]
    if not hasattr(sock, "sendmsg"):
        for b in bufs:
            sock.sendall(b)
        return
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent:
            bufs[0] = bufs[0][sent:]
