"""TCP membership rendezvous — shared-filesystem-free registry
(counterpart: euler_tpu/distributed/rendezvous.py; the leases of replica
groups are not ported: their verbs answer a NotImplementedError frame).

The reference registers graph servers as ephemeral ZooKeeper znodes with a
session keep-alive and clients watch children for add/remove
(euler/common/zk_server_register.cc:96-161, zk_server_monitor.cc). The
shared-dir `Registry` covers single-host and NFS/GCS-fuse pods; real
multi-host TPU pods often share nothing, so this module serves the same
membership table from one TCP endpoint:

  server:  RendezvousServer(port)  — in-memory {(shard, host, port): ts},
           entries expire after `ttl` seconds without a heartbeat
           (ephemeral-znode parity). Run standalone via
           `python -m euler_tpu_torch.distributed.rendezvous --port N`,
           or colocated with any shard service.
  client:  TcpRegistry("host:port") — same register()/lookup()/wait_for()
           surface as Registry, so service.py and client.py stay agnostic.

`make_registry(spec)` picks the backend: "tcp://host:port" → TcpRegistry,
anything else → shared-dir Registry. The rendezvous uses the same
length-prefixed wire frames as the graph service (distributed/wire.py), so
it inherits the fuzz-hardened framing.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time

from euler_tpu_torch.distributed import wire
from euler_tpu_torch.distributed.registry import _LEASES, Registry


class RendezvousServer:
    """In-memory membership table served over TCP.

    Ops (one frame in, one frame out):
      reg   (shard, host, port, meta_json) → ("ok",)   upsert + heartbeat
      unreg (shard, host, port)            → ("ok",)   immediate removal
      lookup ()                            → (table_json,)  live entries
      topo_set (num_shards, gen, epoch)    → ("ok",)   reshard cutover
      topo_get ()                          → (topo_json|"null",)

    The lease verbs of replica groups (lease_acquire / lease_renew /
    lease_observe) answer a typed NotImplementedError frame: replication
    is not ported (ROADMAP queue 1 item 8).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ttl: float = 10.0):
        self.ttl = ttl
        # (shard, host, port) → (last-heartbeat ts, meta_json)
        self._entries: dict[tuple[int, str, int], tuple[float, str]] = {}
        # committed cluster topology (resharding): {"num_shards",
        # "gen", "epoch"} or None. Entries carry their generation in
        # meta["gen"]; lookup filters to the committed gen, making
        # topo_set the atomic cutover flip (registry.py parity).
        self._topology: dict | None = None
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "RendezvousServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                frame = wire.read_frame(conn)
                if frame is None:
                    return
                try:
                    op, vals = wire.decode(frame)
                    reply = self._dispatch(op, vals)
                except Exception as e:  # malformed-frame containment
                    reply = wire.encode("err", [f"{type(e).__name__}: {e}"])
                wire.send_frame(conn, reply)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, op: str, vals: list) -> bytes:
        if op == "reg":
            shard, host, port = int(vals[0]), str(vals[1]), int(vals[2])
            meta_json = str(vals[3]) if len(vals) > 3 else "{}"
            with self._lock:
                self._entries[(shard, host, port)] = (time.time(), meta_json)
            return wire.encode("ok", [])
        if op == "unreg":
            shard, host, port = int(vals[0]), str(vals[1]), int(vals[2])
            with self._lock:
                self._entries.pop((shard, host, port), None)
            return wire.encode("ok", [])
        if op == "lookup":
            now = time.time()
            with self._lock:
                dead = [
                    k for k, (ts, _) in self._entries.items()
                    if now - ts > self.ttl
                ]
                for k in dead:
                    del self._entries[k]
                table = [
                    [s, h, p, self._entries[(s, h, p)][1]]
                    for (s, h, p) in sorted(self._entries)
                ]
                topo = self._topology
            # the committed gen rides the reply so TcpRegistry.lookup can
            # filter client routing without a second round trip
            gen = int(topo.get("gen", 0)) if topo else 0
            return wire.encode("table", [json.dumps(table), gen])
        if op == "topo_set":
            rec = {
                "num_shards": int(vals[0]),
                "gen": int(vals[1]),
                "epoch": int(vals[2]),
            }
            with self._lock:
                self._topology = rec
            return wire.encode("ok", [])
        if op == "topo_get":
            with self._lock:
                topo = self._topology
            return wire.encode(
                "topo", ["null" if topo is None else json.dumps(topo)]
            )
        if op in ("lease_acquire", "lease_renew", "lease_observe"):
            return wire.encode("err", [f"NotImplementedError: {_LEASES}"])
        return wire.encode("err", [f"unknown op {op!r}"])


class TcpRegistry:
    """Registry backed by a RendezvousServer endpoint.

    Same surface as registry.Registry: register() heartbeats in the
    background and returns a stop Event; lookup()/wait_for() read the
    live table. Connections are per-request (the rendezvous is low-QPS
    control plane; reconnects double as liveness probes)."""

    def __init__(self, address: str, ttl: float = 10.0,
                 timeout: float = 5.0):
        if address.startswith("tcp://"):
            address = address[len("tcp://"):]
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.ttl = ttl
        self.timeout = timeout

    def _call(self, op: str, vals: list) -> list:
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ) as sock:
            wire.send_frame(sock, wire.encode(op, vals))
            frame = wire.read_frame(sock)
        if frame is None:
            raise ConnectionError("rendezvous closed connection")
        rop, rvals = wire.decode(frame)
        if rop == "err":
            raise RuntimeError(f"rendezvous error: {rvals[0]}")
        return rvals

    # -- server side -----------------------------------------------------

    def register(self, shard: int, host: str, port: int,
                 meta: dict | None = None):
        """Heartbeat `reg` until the returned Event is set, then `unreg`
        (ephemeral-znode + session keep-alive parity)."""
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                try:
                    # meta is re-serialized EVERY beat (file-backend
                    # parity): replication coordinators mutate the dict
                    # in place so peers see live WAL positions/roles
                    self._call(
                        "reg", [shard, host, port, json.dumps(meta or {})]
                    )
                except (OSError, RuntimeError):
                    # rendezvous briefly away or replying err frames
                    # (e.g. mid-restart): keep beating — a dead heartbeat
                    # thread would silently expire a healthy shard
                    pass
                stop.wait(self.ttl / 3)
            try:
                self._call("unreg", [shard, host, port])
            except (OSError, RuntimeError):
                pass

        threading.Thread(target=beat, daemon=True).start()
        return stop

    # -- client side -----------------------------------------------------

    def lookup(self, num_shards: int) -> dict[int, list[tuple[str, int]]]:
        out: dict[int, list[tuple[str, int]]] = {
            s: [] for s in range(num_shards)
        }
        try:
            vals = self._call("lookup", [])
        except OSError:
            return out
        # reply is [table_json] pre-reshard, [table_json, gen] after: the
        # gen filters client routing to the committed topology generation
        gen = int(vals[1]) if len(vals) > 1 else 0
        for s, h, p, *m in json.loads(vals[0]):
            try:
                entry_gen = int(json.loads(m[0]).get("gen", 0)) if m else 0
            except (ValueError, AttributeError, json.JSONDecodeError):
                entry_gen = 0
            if entry_gen != gen:
                continue
            if int(s) in out:
                out[int(s)].append((str(h), int(p)))
        return out

    def lookup_meta(self) -> dict[tuple[int, str, int], dict]:
        """Full live table including per-entry meta (the shared-dir
        Registry persists meta in its heartbeat files; this is the tcp://
        equivalent)."""
        vals = self._call("lookup", [])
        return {
            (int(s), str(h), int(p)): json.loads(m[0]) if m else {}
            for s, h, p, *m in json.loads(vals[0])
        }

    def members(self, shard: int) -> list[tuple[str, int, dict]]:
        """Live (host, port, meta) entries for one shard group — the
        replica-group view promotion reads peer positions from. Empty on
        a transport fault (the rendezvous mid-restart): callers treat
        that as 'membership unknown', not 'everyone is dead'."""
        try:
            table = self.lookup_meta()
        except (OSError, RuntimeError):
            return []
        return [
            (h, p, meta)
            for (s, h, p), meta in sorted(table.items())
            if s == int(shard)
        ]

    # -- leases: not ported (ROADMAP queue 1 item 8) ----------------------

    def acquire_lease(self, group, holder, ttl, meta=None, min_term=0):
        raise NotImplementedError(_LEASES)

    def renew(self, group, holder, term, ttl):
        raise NotImplementedError(_LEASES)

    def observe(self, group):
        raise NotImplementedError(_LEASES)

    # -- topology (elastic resharding) -----------------------------------

    def set_topology(self, num_shards: int, gen: int, epoch: int) -> dict:
        """Atomically publish the cluster topology — the reshard cutover
        commit point (registry.Registry.set_topology parity)."""
        self._call(
            "topo_set", [int(num_shards), int(gen), int(epoch)]
        )
        return {
            "num_shards": int(num_shards),
            "gen": int(gen),
            "epoch": int(epoch),
        }

    def topology(self) -> dict | None:
        """The committed topology record, or None (pre-reshard cluster
        or a pre-reshard rendezvous server)."""
        try:
            (topo_json,) = self._call("topo_get", [])
        except RuntimeError:
            return None  # pre-reshard rendezvous: unknown op
        topo = json.loads(topo_json)
        return topo if topo else None

    def wait_for(self, num_shards: int, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            table = self.lookup(num_shards)
            if all(table[s] for s in range(num_shards)):
                return table
            time.sleep(0.2)
        raise TimeoutError(
            f"rendezvous at {self.host}:{self.port}: not all "
            f"{num_shards} shards present"
        )


def make_registry(spec: str, ttl: float = 10.0):
    """spec "tcp://host:port" → TcpRegistry; anything else → shared-dir
    Registry (the two deployment modes: bare TCP pods vs NFS/GCS pods)."""
    if spec.startswith("tcp://"):
        return TcpRegistry(spec, ttl=ttl)
    return Registry(spec, ttl=ttl)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="standalone membership rendezvous server"
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--ttl", type=float, default=10.0)
    args = ap.parse_args(argv)
    srv = RendezvousServer(args.host, args.port, ttl=args.ttl).start()
    print(f"rendezvous on {srv.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
