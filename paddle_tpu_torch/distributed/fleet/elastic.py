"""Elastic training membership (counterpart: paddle_tpu/distributed/
fleet/elastic.py, host Python copied).

`ElasticManager` registers this node under the job's prefix of a
key-value store, watches the membership and, when it changes, assigns
ranks again (the sorted hosts, in order) and calls ``on_restart`` with
them; `match`/`status` compare the membership with the elastic target
(``PADDLE_ELASTIC_NP``).  The store is pluggable (put, get, delete,
list); `FileKVStore` keeps it on a shared filesystem, in the JAX
package's layout, so managers of both packages can share one store.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["ElasticManager", "FileKVStore", "ElasticStatus"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class FileKVStore:
    """The membership store on a shared filesystem: a file a key under
    ``root``."""

    def __init__(self, root: str):
        self._root = root
        os.makedirs(root, exist_ok=True)

    def put(self, key: str, value: str):
        path = os.path.join(self._root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[str]:
        path = os.path.join(self._root, key)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return f.read()

    def delete(self, key: str):
        path = os.path.join(self._root, key)
        if os.path.exists(path):
            os.remove(path)

    def list(self, prefix: str) -> Dict[str, str]:
        d = os.path.join(self._root, prefix)
        out = {}
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".tmp"):
                    continue
                with open(os.path.join(d, fn)) as f:
                    out[f"{prefix}/{fn}"] = f.read()
        return out


class ElasticManager:
    """Watches membership; on change, re-ranks and triggers restart.

    ``on_restart(new_ranks: dict)`` is the relaunch hook (a launcher
    kills and respawns its local trainers there)."""

    def __init__(self, kv, job_id: Optional[str] = None,
                 host: Optional[str] = None,
                 np_target: Optional[int] = None,
                 watch_interval_s: float = 0.2,
                 on_restart: Optional[Callable] = None):
        self.kv = kv
        self.job_id = job_id or os.environ.get("PADDLE_JOB_ID", "default")
        self.host = host or os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                           "127.0.0.1:0")
        self.np_target = int(np_target if np_target is not None else
                             os.environ.get("PADDLE_ELASTIC_NP", "1"))
        self.watch_interval_s = watch_interval_s
        self.on_restart = on_restart
        self._prefix = f"{self.job_id}/nodes"
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._last_members: Optional[List[str]] = None
        self.enabled = self.np_target > 0

    # -- membership ---------------------------------------------------------
    def register(self):
        """Publish this node under the job's prefix."""
        self.kv.put(f"{self._prefix}/{self.host.replace(':', '_')}",
                    json.dumps({"host": self.host, "ts": time.time()}))

    def deregister(self):
        self.kv.delete(f"{self._prefix}/{self.host.replace(':', '_')}")

    def hosts(self) -> List[str]:
        vals = self.kv.list(self._prefix)
        return sorted(json.loads(v)["host"] for v in vals.values())

    def _assign_ranks(self, members: List[str]) -> Dict[str, int]:
        return {h: i for i, h in enumerate(members)}

    # -- scale decisions ---------------------------------------------------
    def match(self) -> bool:
        """True when membership equals the elastic target np."""
        return len(self.hosts()) == self.np_target

    def status(self) -> str:
        n = len(self.hosts())
        if n == self.np_target:
            return ElasticStatus.COMPLETED
        return ElasticStatus.HOLD

    # -- the watch loop ----------------------------------------------------
    def start(self):
        self._running = True
        self._last_members = self.hosts()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _watch(self):
        while self._running:
            time.sleep(self.watch_interval_s)
            try:
                members = self.hosts()
            except OSError:
                continue
            if members != self._last_members:
                self._last_members = members
                ranks = self._assign_ranks(members)
                # re-rank, then restart
                if self.on_restart is not None:
                    self.on_restart(ranks)
