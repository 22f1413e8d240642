"""Pluggable durable store for controller (GCS) state.

The seam the reference puts behind `gcs/store_client/store_client.h`
(with `redis_store_client.cc` as the durable implementation and
`in_memory_store_client.cc` for tests): the controller builds its state
snapshot and hands it to a StoreClient; which medium holds it — process
memory, a pickle file, or a sqlite database on durable/shared storage —
is deployment configuration, not controller logic.

Backend selection by `gcs_storage_path`:
  ""                    -> MemoryStoreClient (state dies with the process)
  "*.db" / "*.sqlite"   -> SqliteStoreClient (durable; put it on shared
                           storage and a REPLACEMENT head node restores
                           the cluster — the redis-backed head-failover
                           analogue)
  anything else         -> FileStoreClient  (single pickle snapshot file,
                           the pre-r5 format)

The snapshot is a plain dict (see controller._snapshot_state). The
sqlite backend explodes it into per-entity rows (actors by id, PGs by
id, KV by namespace+key, metadata) and writes only the rows that
CHANGED since the last save — each flush is one short transaction, so a
crash can never leave a torn snapshot and steady-state writes are
proportional to churn, not to cluster size.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

from ray_tpu_torch.utils import get_logger

logger = get_logger("store_client")


class StoreClient:
    """save()/load() a controller state snapshot dict."""

    def save(self, snap: Dict[str, Any]) -> None:
        raise NotImplementedError

    def load(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStoreClient(StoreClient):
    """Process-local (no durability): the default when no storage path
    is configured. Restart-with-state within one process lifetime only —
    matches the reference's in_memory_store_client."""

    def __init__(self) -> None:
        self._snap: Optional[Dict[str, Any]] = None

    def save(self, snap: Dict[str, Any]) -> None:
        self._snap = pickle.loads(pickle.dumps(snap))

    def load(self) -> Optional[Dict[str, Any]]:
        return self._snap


class FileStoreClient(StoreClient):
    """One pickle file, swapped atomically — the pre-r5 snapshot format,
    kept byte-compatible (tests and operators may inspect/rewrite it)."""

    def __init__(self, path: str) -> None:
        self.path = path

    def save(self, snap: Dict[str, Any]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snap, f)
        os.replace(tmp, self.path)  # atomic swap

    def load(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            return pickle.load(f)


class SqliteStoreClient(StoreClient):
    """Durable per-entity rows in sqlite (stdlib): the redis-class
    backend. Tables: gcs(table, key, value) with (table, key) primary
    key. save() diffs against the in-memory mirror and writes only
    changed/removed rows inside one transaction."""

    # snapshot sections stored per-entity (everything else goes under
    # the "meta" table as single rows)
    _ROW_TABLES = ("actors", "pgs")

    def __init__(self, path: str) -> None:
        import sqlite3
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS gcs ("
            " tbl TEXT NOT NULL, key TEXT NOT NULL, value BLOB NOT NULL,"
            " PRIMARY KEY (tbl, key))")
        # Rollback journal (DELETE), not WAL: the advertised deployment
        # puts this file on SHARED storage so a replacement head on
        # another node can open it, and SQLite WAL's -shm mmap breaks on
        # network filesystems. DELETE mode uses plain POSIX locks and
        # stays correct there; flush frequency is low (per dirty tick).
        self._db.execute("PRAGMA journal_mode=DELETE")
        self._db.commit()
        self._mirror: Dict[tuple, bytes] = {}
        for tbl, key, value in self._db.execute(
                "SELECT tbl, key, value FROM gcs"):
            self._mirror[(tbl, key)] = value

    def _explode(self, snap: Dict[str, Any]) -> Dict[tuple, bytes]:
        rows: Dict[tuple, bytes] = {}
        for section in self._ROW_TABLES:
            for entry in snap.get(section, []):
                key = entry.get("actor_id") or entry.get("pg_id")
                rows[(section, key.hex() if isinstance(key, bytes)
                      else str(key))] = pickle.dumps(entry)
        for ns, space in snap.get("kv", {}).items():
            for key, value in space.items():
                # Row key = hex(pickle((ns, key))): unambiguous for any
                # (namespace, key) pair — a separator could collide.
                rid = pickle.dumps((ns, key)).hex()
                rows[("kv", rid)] = pickle.dumps((ns, key, value))
        for name in ("named_actors", "jobs", "next_job"):
            rows[("meta", name)] = pickle.dumps(snap.get(name))
        return rows

    def save(self, snap: Dict[str, Any]) -> None:
        rows = self._explode(snap)
        upserts = [(t, k, v) for (t, k), v in rows.items()
                   if self._mirror.get((t, k)) != v]
        deletes = [tk for tk in self._mirror if tk not in rows]
        if not upserts and not deletes:
            return
        with self._db:  # one transaction
            if upserts:
                self._db.executemany(
                    "INSERT INTO gcs (tbl, key, value) VALUES (?, ?, ?) "
                    "ON CONFLICT (tbl, key) DO UPDATE SET value=excluded.value",
                    upserts)
            if deletes:
                self._db.executemany(
                    "DELETE FROM gcs WHERE tbl=? AND key=?", deletes)
        for t, k, v in upserts:
            self._mirror[(t, k)] = v
        for tk in deletes:
            del self._mirror[tk]

    def load(self) -> Optional[Dict[str, Any]]:
        if not self._mirror:
            return None
        snap: Dict[str, Any] = {"actors": [], "pgs": [], "kv": {}}
        for (tbl, _key), blob in self._mirror.items():
            if tbl in self._ROW_TABLES:
                snap[tbl].append(pickle.loads(blob))
            elif tbl == "kv":
                ns, key, value = pickle.loads(blob)
                snap["kv"].setdefault(ns, {})[key] = value
            elif tbl == "meta":
                snap[_key] = pickle.loads(blob)
        return snap

    def close(self) -> None:
        try:
            self._db.close()
        except Exception:
            pass


def store_client_for(path: str) -> StoreClient:
    if not path:
        return MemoryStoreClient()
    if path.endswith((".db", ".sqlite", ".sqlite3")):
        return SqliteStoreClient(path)
    return FileStoreClient(path)
