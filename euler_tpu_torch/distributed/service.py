"""The pooled TCP server under every wire service
(counterpart: euler_tpu/distributed/service.py:39-378).

Only what the serving front end runs is ported: `current_deadline` and
`_PoolServer` (the selector thread, the worker pool, drain, the deadline
envelope, the chaos server hook and the per-verb wire byte counters).
The graph shard server itself, `GraphService` and `serve_shard`, needs
the store's wire verbs, the WAL and replication: ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import os
import queue
import selectors
import socket
import struct
import threading
import time

from euler_tpu_torch.distributed import chaos, wire


# per-request context (worker-thread confined): the absolute monotonic
# deadline unwrapped from the wire envelope, readable by services whose
# dispatch wants it (ModelServer derives the batcher deadline from it)
_REQUEST = threading.local()


def current_deadline() -> float | None:
    """Absolute time.monotonic() deadline of the request this worker is
    dispatching, or None when the client sent no budget."""
    return getattr(_REQUEST, "deadline", None)


class _PoolServer:
    """Bounded worker-pool TCP server (the reference serves with a fixed
    set of completion-queue threads, grpc_worker_service.cc:48-96, not a
    thread per connection).

    One selector thread watches every idle connection; when a connection
    turns readable it is handed to the pool, where a worker runs the full
    request cycle — blocking frame read, dispatch (the native engine
    releases the GIL inside its C++ calls), wire encode (no shared lock) —
    then parks the connection back on the selector. The protocol is
    request/response lockstep per connection, so a connection is owned by
    at most one worker at a time and thread count stays constant no matter
    how many clients connect.

    The JAX server's separate pool for fan-out ops (a graph shard that
    coordinates leaf RPCs to its peers) comes with the graph tier (ROADMAP
    queue 1 item 8): no service of the port fans out.
    """

    def __init__(self, addr, service, workers: int | None = None):
        self.service = service
        self.lsock = socket.create_server(addr, backlog=128)
        self.lsock.setblocking(False)
        self.server_address = self.lsock.getsockname()
        self.num_workers = workers or min(
            32, max(2, (os.cpu_count() or 1) * 2)
        )
        self._sel = selectors.DefaultSelector()
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._park: queue.SimpleQueue = queue.SimpleQueue()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # drain support: requests currently queued or executing; guarded
        # by the condition so drain() can wait for quiescence
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._accepting = True

    def start(self):
        self._sel.register(self.lsock, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()
        self._threads.append(t)
        for _ in range(self.num_workers):
            w = threading.Thread(target=self._worker, daemon=True)
            w.start()
            self._threads.append(w)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful quiesce: stop accepting NEW connections, then wait for
        every queued/executing request to finish (requests already in the
        pipe on parked connections still get answers). True when the
        server went quiet, False on timeout — callers proceed to a hard
        shutdown either way."""
        self._accepting = False
        deadline = time.monotonic() + timeout_s
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True

    def _inflight_inc(self):
        with self._inflight_cv:
            self._inflight += 1

    def _inflight_dec(self):
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def shutdown(self):
        self._stop.set()
        self._wake_w.send(b"x")  # unblock the selector
        for _ in range(self.num_workers):
            self._jobs.put(None)  # unblock workers

    def server_close(self):
        self.lsock.close()
        self._wake_r.close()
        self._wake_w.close()
        # close every live connection: a worker blocked in read_frame on an
        # idle-but-open client socket only returns when the peer hangs up,
        # so without this the shutdown sentinels are never consumed and
        # connection sockets leak until process exit
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _close_conn(self, conn):
        with self._conns_lock:
            self._conns.discard(conn)
        try:
            conn.close()
        except OSError:
            pass

    # -- selector thread ---------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            for key, _ in self._sel.select(timeout=0.5):
                if key.data == "accept":
                    try:
                        conn, _ = self.lsock.accept()
                    except OSError:
                        continue
                    if not self._accepting:
                        # draining: refuse new connections immediately so
                        # clients fail over instead of queueing behind a
                        # server that is on its way out
                        try:
                            conn.close()
                        except OSError:
                            pass
                        continue
                    conn.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                    conn.setblocking(True)
                    with self._conns_lock:
                        self._conns.add(conn)
                    self._sel.register(conn, selectors.EVENT_READ, "conn")
                elif key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    while True:  # re-register connections workers parked
                        try:
                            conn = self._park.get_nowait()
                        except queue.Empty:
                            break
                        try:
                            self._sel.register(
                                conn, selectors.EVENT_READ, "conn"
                            )
                        except (OSError, ValueError):
                            self._close_conn(conn)
                else:  # a parked connection has a request pending
                    self._sel.unregister(key.fileobj)
                    self._inflight_inc()
                    self._jobs.put(key.fileobj)

    # -- worker threads ------------------------------------------------------

    def _worker(self):
        while True:
            conn = self._jobs.get()
            if conn is None:
                return
            try:
                disposition = self._serve_one(conn)
            except Exception:
                # a malformed frame must cost the CONNECTION, not the
                # worker — a dead worker would silently shrink the pool
                disposition = "close"
            self._finish(conn, disposition)

    def _finish(self, conn, disposition: str):
        if disposition == "park":
            self._inflight_dec()
            self._park.put(conn)
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass
        elif disposition == "close":
            self._inflight_dec()
            self._close_conn(conn)

    def _serve_one(self, sock: socket.socket) -> str:
        try:
            payload = wire.read_frame(sock)
        except (ConnectionError, OSError):
            return "close"
        if payload is None:
            return "close"
        op, args = wire.decode(payload)
        # deadline envelope: the client shipped its REMAINING budget in
        # relative ms (clocks are never compared); anchor it here, at
        # frame receipt, so queueing delay inside this server counts
        op, budget_ms = wire.unwrap_deadline(op)
        counters = getattr(self.service, "wire_bytes_in", None)
        if counters is not None:
            counters[op] += 4 + len(payload)
        deadline = (
            time.monotonic() + budget_ms / 1e3
            if budget_ms is not None
            else None
        )
        return self._respond(sock, op, args, deadline)

    def _respond(self, sock: socket.socket, op, args, deadline=None) -> str:
        # already-expired work is rejected with a typed err frame BEFORE
        # dispatch: the client gave up waiting, so the answer would only
        # burn a worker the live requests need
        if deadline is not None and time.monotonic() > deadline:
            return self._send(
                sock,
                wire.encode(
                    "err",
                    [f"DeadlineExceeded: {op!r} expired before dispatch"],
                ),
            )
        plan = chaos.active_plan()
        corrupt = truncate = False
        if plan is not None:
            decisions = plan.decisions(
                "server", op, shard=getattr(self.service, "shard", None)
            )
            for d in decisions:
                if d.kind == "delay":
                    time.sleep(d.delay_s)
                elif d.kind == "err":
                    return self._send(sock, wire.encode("err", [d.message]))
                elif d.kind == "eof":
                    return "close"
                elif d.kind == "reset":
                    self._rst(sock)
                    return "close"
                elif d.kind == "blackhole":
                    time.sleep(d.hold_s)
                    return "close"
                elif d.kind == "corrupt":
                    corrupt = True
                elif d.kind == "truncate":
                    truncate = True
        _REQUEST.deadline = deadline
        try:
            result = self.service.dispatch(op, args)
            # vectored response: big result arrays leave as iovecs
            # straight from the store's buffers, never staged into a
            # flat frame copy
            frame = wire.encode_vectored("ok", result)
        except Exception as e:  # report (typed by class name), keep serving
            frame = wire.encode("err", [f"{type(e).__name__}: {e}"])
        finally:
            _REQUEST.deadline = None
        if truncate or corrupt:
            # chaos paths need a flat mutable frame to tear/flip
            flat = bytearray().join(
                frame if isinstance(frame, list) else [frame]
            )
            if truncate:
                # torn frame: correct length prefix, then the stream dies
                try:
                    sock.sendall(flat[: max(5, len(flat) // 2)])
                except (ConnectionError, OSError):
                    pass
                return "close"
            for i in range(4, len(flat), max(1, len(flat) // 8)):
                flat[i] ^= 0xFF
            frame = flat
        counters = getattr(self.service, "wire_bytes_out", None)
        if counters is not None:
            counters[op] += wire.frame_nbytes(frame)
        return self._send(sock, frame)

    def _send(self, sock: socket.socket, frame) -> str:
        try:
            wire.send_frame(sock, frame)
        except (ConnectionError, OSError):
            return "close"
        return "park"

    @staticmethod
    def _rst(sock: socket.socket) -> None:
        """Arrange for close() to RST instead of FIN (SO_LINGER 0)."""
        try:
            sock.setsockopt(
                socket.SOL_SOCKET,
                socket.SO_LINGER,
                struct.pack("ii", 1, 0),
            )
        except OSError:
            pass


class GraphService:
    """Graph shard server: not ported (ROADMAP queue 1 item 8)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GraphService is not ported yet (ROADMAP queue 1 item 8: the "
            "distributed graph tier)"
        )


def serve_shard(*args, **kwargs):
    """Boot one graph shard server: not ported (ROADMAP queue 1 item 8)."""
    raise NotImplementedError(
        "serve_shard is not ported yet (ROADMAP queue 1 item 8: the "
        "distributed graph tier)"
    )
