"""Shared-filesystem membership registry — the ZooKeeper replacement
(counterpart: euler_tpu/distributed/registry.py; the leases of replica
groups are not ported).

The reference registers graph servers as ephemeral ZK znodes
`<path>/<shard>#<host:port>` with shard metadata and re-registers on session
loss (euler/common/zk_server_register.cc:96-161); clients watch children and
get add/remove callbacks (server_monitor.h:33-40). TPU-VM pods share a
filesystem (NFS/GCS-fuse) far more often than they run ZK, so membership
here is heartbeat files in a directory: servers rewrite
`shard_<i>@<host>_<port>.json` every interval; entries whose heartbeat is
stale are treated as removed. Static cluster specs bypass the registry
entirely.
"""

from __future__ import annotations

import json
import os
import threading
import time

_LEASES = (
    "registry leases are not ported yet (ROADMAP queue 1 item 8: the "
    "replica groups of the distributed graph tier)"
)


class Registry:
    def __init__(self, path: str, ttl: float = 10.0):
        self.path = path
        self.ttl = ttl
        os.makedirs(path, exist_ok=True)

    def _entry_path(self, shard: int, host: str, port: int) -> str:
        return os.path.join(self.path, f"shard_{shard}@{host}_{port}.json")

    # -- server side -----------------------------------------------------

    def register(self, shard: int, host: str, port: int, meta: dict | None = None):
        """Write a heartbeat entry now; returns a stop() handle that keeps
        re-registering in the background (ZK session keep-alive parity)."""
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                entry = {
                    "shard": shard,
                    "host": host,
                    "port": port,
                    "ts": time.time(),
                    "meta": meta or {},
                }
                tmp = self._entry_path(shard, host, port) + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(entry, f)
                os.replace(tmp, self._entry_path(shard, host, port))
                stop.wait(self.ttl / 3)
            try:
                os.remove(self._entry_path(shard, host, port))
            except OSError:
                pass

        t = threading.Thread(target=beat, daemon=True)
        t.start()
        return stop

    # -- leases ------------------------------------------------------------
    #
    # The replica-group lease (term-numbered, TTL'd, the fencing token of
    # replication) serves the graph tier's replica groups, which are not
    # ported: ROADMAP queue 1 item 8.

    def acquire_lease(self, group, holder, ttl, meta=None, min_term=0):
        raise NotImplementedError(_LEASES)

    def renew(self, group, holder, term, ttl):
        raise NotImplementedError(_LEASES)

    def observe(self, group):
        raise NotImplementedError(_LEASES)

    # -- topology (elastic resharding) -----------------------------------
    #
    # One `topology.json` record per registry: {"num_shards", "gen",
    # "epoch"}. `gen` is the membership generation — heartbeat entries
    # carry their generation in meta["gen"] (absent = 0), and client-facing
    # lookup() only returns entries of the CURRENT generation. A reshard
    # boots destination shards at gen+1 (invisible to clients), then
    # commits the whole topology flip with one set_topology() — the atomic
    # cutover point: old-gen sources vanish from routing and new-gen
    # destinations appear in the same read. No topology file means gen 0,
    # so pre-reshard clusters (whose entries carry no gen) are unchanged.

    def _topology_path(self) -> str:
        return os.path.join(self.path, "topology.json")

    def set_topology(self, num_shards: int, gen: int, epoch: int) -> dict:
        """Atomically publish the cluster topology (fsync'd tmp + rename
        — a torn cutover must never be observable)."""
        rec = {
            "num_shards": int(num_shards),
            "gen": int(gen),
            "epoch": int(epoch),
        }
        tmp = self._topology_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._topology_path())
        return rec

    def topology(self) -> dict | None:
        """The committed topology record, or None (pre-reshard cluster)."""
        try:
            with open(self._topology_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _current_gen(self) -> int:
        topo = self.topology()
        return int(topo.get("gen", 0)) if topo else 0

    @staticmethod
    def _entry_gen(meta: dict | None) -> int:
        try:
            return int((meta or {}).get("gen", 0))
        except (TypeError, ValueError):
            return 0

    # -- client side -----------------------------------------------------

    def lookup_meta(
        self, num_shards: int
    ) -> dict[int, list[tuple[str, int, dict]]]:
        """shard → [(host, port, meta), ...] with live heartbeats — the
        meta carries replica ids and shipped WAL positions (replication
        promotion reads peer positions from here)."""
        now = time.time()
        out: dict[int, list[tuple[str, int, dict]]] = {
            s: [] for s in range(num_shards)
        }
        for name in sorted(os.listdir(self.path)):
            if not name.endswith(".json") or name.startswith("lease_"):
                continue
            if name == "topology.json":
                continue
            try:
                with open(os.path.join(self.path, name)) as f:
                    e = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if now - e.get("ts", 0) > self.ttl:
                continue
            s = int(e["shard"])
            if s in out:
                out[s].append((e["host"], int(e["port"]), e.get("meta") or {}))
        return out

    def members(self, shard: int) -> list[tuple[str, int, dict]]:
        """Live (host, port, meta) entries for one shard group — the
        replica-group view promotion reads peer positions from."""
        try:
            return self.lookup_meta(int(shard) + 1)[int(shard)]
        except OSError:
            return []

    def lookup(self, num_shards: int) -> dict[int, list[tuple[str, int]]]:
        """shard → [(host, port), ...] with live heartbeats, restricted
        to the current topology generation (client routing view — a
        mid-reshard destination at gen+1 stays invisible here until
        set_topology commits the flip)."""
        now = time.time()
        gen = self._current_gen()
        out: dict[int, list[tuple[str, int]]] = {
            s: [] for s in range(num_shards)
        }
        for name in sorted(os.listdir(self.path)):
            if not name.endswith(".json") or name.startswith("lease_"):
                continue
            if name == "topology.json":
                continue
            try:
                with open(os.path.join(self.path, name)) as f:
                    e = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if now - e.get("ts", 0) > self.ttl:
                continue
            if self._entry_gen(e.get("meta")) != gen:
                continue
            s = int(e["shard"])
            if s in out:
                out[s].append((e["host"], int(e["port"])))
        return out

    def wait_for(self, num_shards: int, timeout: float = 30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            table = self.lookup(num_shards)
            if all(table[s] for s in range(num_shards)):
                return table
            time.sleep(0.2)
        raise TimeoutError(
            f"registry at {self.path}: not all {num_shards} shards present"
        )
