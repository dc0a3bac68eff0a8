"""The parameter server (counterpart: paddle_tpu/distributed/ps/
__init__.py).

The server core is the JAX package's ``csrc/ps_server.cc`` (TCP,
host-memory dense, sparse, SSD-backed sparse and graph tables,
server-side optimizers), built and loaded by the port's own `_native`
loader, so a port client and a JAX server (or the reverse) speak one
wire format.  The Python surface is the JAX module's: `PSServer` and
`PSClient`, `shard_dense_sizes` and `ShardedPSClient` (dense tables
split in contiguous blocks over the servers, sparse ids by modulo),
`Communicator` in its three modes, and the heterogeneous service
(`HeterServer` / `HeterClient` over `_enc_arrays` / `_dec_arrays`):

- sync  — push gradients / barrier / pull each step;
- async — a background thread merges gradients and pushes them on an
          interval, then pulls fresh parameters;
- geo   — trainers train locally; every ``k_steps`` they push parameter
          deltas (the server adds them) and pull the merged parameters.

At the boundary it takes numpy arrays, as the JAX package does, and
torch tensors (a CUDA tensor is copied to the host for a push); a pull
returns numpy.  A request hands the native client the array's own
buffer and receives into a numpy buffer, without the byte-string copies
of the JAX module.
"""
from __future__ import annotations

import ctypes
import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import _native

__all__ = ["PSServer", "PSClient", "ShardedPSClient", "Communicator",
           "HeterServer", "HeterClient", "shard_dense_sizes"]

OP_PULL_DENSE = 1
OP_PUSH_DENSE_GRAD = 2
OP_SET_DENSE = 3
OP_PULL_SPARSE = 4
OP_PUSH_SPARSE_GRAD = 5
OP_BARRIER = 6
OP_STOP = 7
OP_PUSH_DENSE_DELTA = 8
OP_SAVE_TABLES = 9
OP_GRAPH_ADD_EDGES = 10
OP_GRAPH_SAMPLE_NEIGHBORS = 11
OP_GRAPH_SET_NODE_FEAT = 12
OP_GRAPH_GET_NODE_FEAT = 13

def _lib():
    return _native.load()


def _host(a, dtype) -> np.ndarray:
    """A C-contiguous numpy array of ``dtype`` holding ``a`` (a torch
    tensor is copied to the host first)."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


class PSServer:
    """The native parameter server, in this process (its own threads)."""

    # wire codes differ per table kind — use the string names in Python
    DENSE_OPTS = {"sgd": 0, "adagrad": 1, "sum": 2, "adam": 3}
    SPARSE_OPTS = {"sgd": 0, "adagrad": 1, "adam": 2}

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.ptrt_ps_server_create()
        self.port = None
        self.stopped = False

    def create_dense_table(self, table_id, size, lr=0.01, optimizer="sgd"):
        self._lib.ptrt_ps_server_create_dense_table(
            self._h, table_id, int(size), float(lr),
            self.DENSE_OPTS[optimizer])

    def create_sparse_table(self, table_id, dim, lr=0.01, optimizer="sgd"):
        rc = self._lib.ptrt_ps_server_create_sparse_table(
            self._h, table_id, int(dim), float(lr),
            self.SPARSE_OPTS[optimizer])
        if rc != 0:
            raise ValueError(f"invalid sparse optimizer {optimizer!r}")

    def create_sparse_table_ssd(self, table_id, dim, mem_budget_rows,
                                spill_path, lr=0.01, optimizer="sgd"):
        """SSD-spillable sparse table: at most
        ``mem_budget_rows`` rows stay in host memory; the LRU overflow
        (param + optimizer slots) lives in the slotted ``spill_path``
        file.  save()/load() snapshots fold spilled rows in, so tables
        larger than the budget survive a restart."""
        rc = self._lib.ptrt_ps_server_create_sparse_table_ssd(
            self._h, table_id, int(dim), float(lr),
            self.SPARSE_OPTS[optimizer], int(mem_budget_rows),
            str(spill_path).encode())
        if rc != 0:
            raise ValueError(
                f"create_sparse_table_ssd failed (optimizer {optimizer!r}, "
                f"path {spill_path!r})")

    def create_graph_table(self, table_id, feat_dim=0):
        """Graph table: weighted adjacency and per-node features, served
        over the same transport for GNN neighbor sampling."""
        self._lib.ptrt_ps_server_create_graph_table(self._h, table_id,
                                                    int(feat_dim))

    def start(self, port=0, n_trainers=1, host="127.0.0.1"):
        """Bind defaults to loopback — the wire protocol is unauthenticated;
        pass host="0.0.0.0" explicitly for a trusted multi-host
        network."""
        self.port = self._lib.ptrt_ps_server_start(self._h, int(port),
                                                   int(n_trainers),
                                                   host.encode())
        if self.port < 0:
            raise RuntimeError(f"PS server failed to bind {host}:{port}")
        return self.port

    def save(self, path: str) -> None:
        """Persist all tables and optimizer slots."""
        if self._lib.ptrt_ps_server_save(self._h, str(path).encode()) != 0:
            raise RuntimeError(f"PS server save to {path} failed")

    def load(self, path: str) -> None:
        """Restore tables saved by save(); call before start()."""
        if self._lib.ptrt_ps_server_load(self._h, str(path).encode()) != 0:
            raise RuntimeError(f"PS server load from {path} failed")

    def stop(self):
        if self._h:
            self._lib.ptrt_ps_server_stop(self._h)
        self.stopped = True

    def is_stopped(self) -> bool:
        """True once the native server saw a stop — locally via stop() or
        remotely via a client OP_STOP."""
        if self.stopped:
            return True
        return bool(self._h and self._lib.ptrt_ps_server_stopped(self._h))

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ptrt_ps_server_stop(self._h)
                self._lib.ptrt_ps_server_destroy(self._h)
                self._h = None
        except Exception:
            pass


class PSClient:
    """A trainer's connection to one server."""

    def __init__(self, host="127.0.0.1", port=0):
        self._lib = _lib()
        self._h = self._lib.ptrt_ps_client_create()
        rc = self._lib.ptrt_ps_client_connect(self._h, host.encode(),
                                              int(port))
        if rc != 0:
            raise ConnectionError(f"cannot connect PS at {host}:{port}")

    def _request(self, op, table, n, payload, out_cap: int) -> np.ndarray:
        """One request; ``payload`` is bytes or a contiguous numpy array
        (passed by pointer); returns the reply's bytes as uint8."""
        out = np.empty(out_cap, np.uint8) if out_cap else None
        out_len = ctypes.c_uint64(0)
        if isinstance(payload, np.ndarray):
            ptr, plen = payload.ctypes.data, payload.nbytes
        else:
            ptr, plen = payload, len(payload) if payload else 0
        rc = self._lib.ptrt_ps_client_request(
            self._h, op, table, n, ptr, plen,
            out.ctypes.data if out is not None else None, out_cap,
            ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"PS request op={op} failed rc={rc}")
        return out[:out_len.value] if out is not None else \
            np.empty(0, np.uint8)

    def pull_dense(self, table, size) -> np.ndarray:
        raw = self._request(OP_PULL_DENSE, table, size, b"",
                            size * 4 + 16)
        return raw[:size * 4].view(np.float32)

    def push_dense_grad(self, table, grad):
        g = _host(grad, np.float32)
        self._request(OP_PUSH_DENSE_GRAD, table, g.size, g, 0)

    def push_dense_delta(self, table, delta):
        d = _host(delta, np.float32)
        self._request(OP_PUSH_DENSE_DELTA, table, d.size, d, 0)

    def set_dense(self, table, value):
        v = _host(value, np.float32)
        self._request(OP_SET_DENSE, table, v.size, v, 0)

    def pull_sparse(self, table, ids, dim: int) -> np.ndarray:
        ids = _host(ids, np.uint64)
        raw = self._request(OP_PULL_SPARSE, table, ids.size, ids,
                            ids.size * dim * 4 + 16)
        return raw[:ids.size * dim * 4].view(np.float32).reshape(
            ids.size, dim)

    def push_sparse_grad(self, table, ids, grads):
        ids = _host(ids, np.uint64)
        g = _host(grads, np.float32)
        self._request(OP_PUSH_SPARSE_GRAD, table, ids.size,
                      ids.tobytes() + g.tobytes(), 0)

    # -- the graph service --------------------------------------------------
    def add_graph_edges(self, table, src, dst, weight=None):
        src = _host(src, np.uint64)
        dst = _host(dst, np.uint64)
        w = (_host(weight, np.float32) if weight is not None
             else np.ones(src.size, np.float32))
        rec = np.zeros(src.size, dtype=[("s", "<u8"), ("d", "<u8"),
                                        ("w", "<f4")])
        rec["s"], rec["d"], rec["w"] = src, dst, w
        self._request(OP_GRAPH_ADD_EDGES, table, src.size, rec.tobytes(), 0)

    def sample_neighbors(self, table, ids, sample_size: int, seed: int = 0):
        """Weighted neighbor sampling without replacement
        (Efraimidis-Spirakis keys from a deterministic splitmix hash —
        replayable in numpy).  Returns (neighbors [n, sample_size] uint64
        0-padded, counts [n] int32)."""
        ids = _host(ids, np.uint64)
        k = int(sample_size)
        payload = (np.uint32(k).tobytes() + np.uint32(seed).tobytes() +
                   ids.tobytes())
        rec_bytes = 4 + k * 8
        raw = self._request(OP_GRAPH_SAMPLE_NEIGHBORS, table, ids.size,
                            payload, ids.size * rec_bytes + 16)
        rec = raw[:ids.size * rec_bytes].reshape(ids.size, rec_bytes)
        counts = rec[:, :4].copy().view(np.int32).reshape(-1)
        nbrs = rec[:, 4:].copy().view(np.uint64).reshape(ids.size, k)
        return nbrs, counts

    def set_node_feat(self, table, ids, feats):
        ids = _host(ids, np.uint64)
        f = _host(feats, np.float32).reshape(ids.size, -1)
        rec = ids.reshape(-1, 1).view(np.uint8).reshape(ids.size, 8)
        payload = np.concatenate(
            [rec, f.view(np.uint8).reshape(ids.size, -1)],
            axis=1).tobytes()
        self._request(OP_GRAPH_SET_NODE_FEAT, table, ids.size, payload, 0)

    def get_node_feat(self, table, ids, dim: int) -> np.ndarray:
        ids = _host(ids, np.uint64)
        raw = self._request(OP_GRAPH_GET_NODE_FEAT, table, ids.size, ids,
                            ids.size * dim * 4 + 16)
        return raw[:ids.size * dim * 4].view(np.float32).reshape(
            ids.size, dim)

    def barrier(self, trainer_id=None, table=0):
        """Block until all n_trainers distinct trainer ids arrive (restarts
        of the same id don't double-count).  trainer_id defaults from
        PADDLE_TRAINER_ID so distinct launched workers stay distinct."""
        if trainer_id is None:
            trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._request(OP_BARRIER, table, int(trainer_id), b"", 0)

    def save_tables(self, path: str):
        """Ask the server to persist its tables to `path` (server-host
        filesystem)."""
        self._request(OP_SAVE_TABLES, 0, 0, str(path).encode(), 0)

    def stop_server(self):
        try:
            self._request(OP_STOP, 0, 0, b"", 0)
        except RuntimeError:
            pass

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ptrt_ps_client_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def shard_dense_sizes(total: int, n_shards: int) -> List[int]:
    """Contiguous block partition of a dense table across servers: even
    blocks, the remainder spread over the leading shards."""
    base, rem = divmod(int(total), n_shards)
    return [base + (1 if i < rem else 0) for i in range(n_shards)]


class ShardedPSClient:
    """Client-side routing over several servers, the shards' requests
    sent concurrently.

    - dense tables are split into contiguous blocks, one block per server
      (`shard_dense_sizes`); pull concatenates, push scatters.
    - sparse rows route by ``id % n_servers``, so each server owns a
      disjoint id set.
    Servers must be created with the per-shard sizes, e.g. via
    ``create_dense_table(tid, shard_dense_sizes(total, n)[i])`` on server i.
    """

    def __init__(self, endpoints: List):
        """endpoints: list of (host, port) or "host:port" strings."""
        from concurrent.futures import ThreadPoolExecutor

        self.clients: List[PSClient] = []
        for ep in endpoints:
            if isinstance(ep, str):
                host, port = ep.rsplit(":", 1)
            else:
                host, port = ep
            self.clients.append(PSClient(host, int(port)))
        self.n = len(self.clients)
        self._dense_sizes: Dict[int, List[int]] = {}
        # the shards' requests go out concurrently; each PSClient
        # serializes its own socket
        self._pool = ThreadPoolExecutor(max_workers=self.n,
                                        thread_name_prefix="ps-shard")

    def _fanout(self, calls):
        """Run [(fn, args...)] concurrently, return results in order."""
        futs = [self._pool.submit(fn, *args) for fn, *args in calls]
        return [f.result() for f in futs]

    def register_dense(self, table_id, total_size):
        self._dense_sizes[table_id] = shard_dense_sizes(total_size, self.n)

    def _splits(self, table_id, total=None):
        sizes = self._dense_sizes.get(table_id)
        if sizes is None:
            if total is None:
                raise KeyError(f"dense table {table_id} not registered")
            sizes = shard_dense_sizes(total, self.n)
            self._dense_sizes[table_id] = sizes
        return sizes

    # -- dense ---------------------------------------------------------------
    def pull_dense(self, table, size) -> np.ndarray:
        sizes = self._splits(table, size)
        parts = self._fanout([(c.pull_dense, table, s)
                              for c, s in zip(self.clients, sizes) if s])
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def _scatter_dense(self, table, arr, fn_name):
        arr = _host(arr, np.float32).reshape(-1)
        sizes = self._splits(table, arr.size)
        calls, off = [], 0
        for c, s in zip(self.clients, sizes):
            if s:
                calls.append((getattr(c, fn_name), table, arr[off:off + s]))
            off += s
        self._fanout(calls)

    def push_dense_grad(self, table, grad):
        self._scatter_dense(table, grad, "push_dense_grad")

    def push_dense_delta(self, table, delta):
        self._scatter_dense(table, delta, "push_dense_delta")

    def set_dense(self, table, value):
        self._scatter_dense(table, value, "set_dense")

    # -- sparse --------------------------------------------------------------
    def pull_sparse(self, table, ids, dim: int) -> np.ndarray:
        ids = _host(ids, np.uint64)
        shard = (ids % np.uint64(self.n)).astype(np.int64)
        out = np.zeros((ids.size, dim), np.float32)
        masks = [shard == s for s in range(self.n)]
        calls = [(self.clients[s].pull_sparse, table, ids[m], dim)
                 for s, m in enumerate(masks) if m.any()]
        results = self._fanout(calls)
        ri = 0
        for m in masks:
            if m.any():
                out[m] = results[ri]
                ri += 1
        return out

    def push_sparse_grad(self, table, ids, grads):
        ids = _host(ids, np.uint64)
        grads = _host(grads, np.float32).reshape(ids.size, -1)
        shard = (ids % np.uint64(self.n)).astype(np.int64)
        self._fanout([
            (self.clients[s].push_sparse_grad, table, ids[shard == s],
             grads[shard == s])
            for s in range(self.n) if (shard == s).any()
        ])

    # -- control -------------------------------------------------------------
    def barrier(self, trainer_id=None, table=0):
        # one designated server arbitrates the barrier; all trainers use the
        # same fan-out order so server 0 is consistent across the job
        self.clients[0].barrier(trainer_id, table)

    def save_tables(self, path_prefix: str):
        """Each server persists its shard to `{prefix}.shard{i}`."""
        self._fanout([(c.save_tables, f"{path_prefix}.shard{i}")
                      for i, c in enumerate(self.clients)])

    def stop_servers(self):
        for c in self.clients:
            c.stop_server()

    def close(self):
        self._pool.shutdown(wait=False)
        for c in self.clients:
            c.close()


class Communicator:
    """The trainer's gradient communicator: in async mode trainers
    enqueue gradients and a background thread merges a table's
    gradients and pushes them, then pulls fresh parameters into a cache
    the trainer reads at its own pace.  In geo mode `geo_step` syncs a
    table's deltas every ``k_steps`` calls instead."""

    def __init__(self, client: PSClient, mode="async", send_interval_s=0.01,
                 merge_size=4, k_steps=4):
        self.client = client
        self.mode = mode
        self.send_interval_s = send_interval_s
        self.merge_size = merge_size
        self.k_steps = max(1, int(k_steps))
        self._q: "queue.Queue" = queue.Queue()
        self._params: Dict[int, np.ndarray] = {}
        self._sizes: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._send_error: Optional[Exception] = None
        self._geo_old: Dict[int, np.ndarray] = {}
        self._geo_tick: Dict[int, int] = {}

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def is_running(self):
        return self._running

    # -- trainer API --------------------------------------------------------
    def register_dense(self, table_id, size):
        self._sizes[table_id] = int(size)

    def send(self, table_id, grad: np.ndarray):
        """Enqueue a dense grad for async merge+push.  Once the background
        thread has died, every call raises (the error is sticky — the
        thread does not restart, so silently queueing would grow forever)."""
        if self._send_error is not None:
            raise RuntimeError(
                "PS communicator send thread failed; restart the "
                "communicator") from self._send_error
        self._q.put((table_id, _host(grad, np.float32)))

    def recv(self, table_id) -> Optional[np.ndarray]:
        """Latest pulled params (may lag; that's the async contract)."""
        with self._lock:
            p = self._params.get(table_id)
        if p is None:  # first touch: synchronous pull
            p = self.client.pull_dense(table_id, self._sizes[table_id])
            with self._lock:
                self._params[table_id] = p
        return p

    def geo_step(self, table_id, local_param: np.ndarray) -> np.ndarray:
        """GEO-SGD: every k calls push (local - last_synced) as a delta and
        pull the merged global params; returns the params the trainer
        should continue from."""
        local = _host(local_param, np.float32)
        tick = self._geo_tick.get(table_id, 0) + 1
        self._geo_tick[table_id] = tick
        if table_id not in self._geo_old:
            # last-synced state is the SERVER's params (the trainer may
            # already have stepped locally before the first geo_step)
            self._geo_old[table_id] = self.client.pull_dense(
                table_id, local.size).reshape(local.shape)
        if tick % self.k_steps:
            return local
        delta = local - self._geo_old[table_id]
        self.client.push_dense_delta(table_id, delta)
        fresh = self.client.pull_dense(table_id, local.size).reshape(
            local.shape)
        self._geo_old[table_id] = fresh.copy()
        return fresh

    # -- background loop ----------------------------------------------------
    def _loop(self):
        while self._running:
            merged: Dict[int, np.ndarray] = {}
            count = 0
            deadline = time.monotonic() + self.send_interval_s
            while count < self.merge_size and time.monotonic() < deadline:
                try:
                    tid, g = self._q.get(timeout=self.send_interval_s)
                except queue.Empty:
                    break
                merged[tid] = g if tid not in merged else merged[tid] + g
                count += 1
            for tid, g in merged.items():
                try:
                    self.client.push_dense_grad(tid, g)
                    # size falls back to the pushed grad's size so an
                    # unregistered table cannot kill the send thread
                    size = self._sizes.get(tid, g.size)
                    fresh = self.client.pull_dense(tid, size)
                    with self._lock:
                        self._params[tid] = fresh
                except Exception as e:  # noqa: BLE001 — surfaced via send()
                    if self._running:
                        self._send_error = e
                        self._running = False
                    return


# ---------------------------------------------------------------------------
# The heterogeneous trainer service: a worker offloads part of its step,
# by name, to a peer process holding other hardware.  The framing is the
# PS transport's; payloads are named numpy arrays.
# ---------------------------------------------------------------------------


# Wire codec of the heter service: a restricted binary encoding of
# (name/status, [numpy arrays]).  Deliberately NOT pickle — the transport
# is unauthenticated, and pickle would escalate data tampering to
# arbitrary code execution.  Byte for byte the JAX package's.
def _enc_arrays(tag: str, arrays) -> bytes:
    tb = tag.encode()
    out = [struct.pack("<H", len(tb)), tb,
           struct.pack("<H", len(arrays))]
    for a in arrays:
        a = np.ascontiguousarray(_host(a, None) if hasattr(a, "detach")
                                 else a)
        ds = a.dtype.str.encode()
        out.append(struct.pack("<H", len(ds)))
        out.append(ds)
        out.append(struct.pack("<B", a.ndim))
        out.append(struct.pack(f"<{a.ndim}q", *a.shape) if a.ndim else b"")
        out.append(struct.pack("<Q", a.nbytes))
        out.append(a.tobytes())
    return b"".join(out)


def _dec_arrays(buf: bytes):
    off = 0

    def take(n):
        nonlocal off
        if off + n > len(buf):
            raise ValueError("truncated heter message")
        b = buf[off:off + n]
        off += n
        return b

    (tl,) = struct.unpack("<H", take(2))
    tag = take(tl).decode()
    (cnt,) = struct.unpack("<H", take(2))
    arrays = []
    for _ in range(cnt):
        (dl,) = struct.unpack("<H", take(2))
        dt = np.dtype(take(dl).decode())
        if dt.hasobject:
            raise ValueError("object dtypes are not allowed on the wire")
        (ndim,) = struct.unpack("<B", take(1))
        shape = struct.unpack(f"<{ndim}q", take(8 * ndim)) if ndim else ()
        (nbytes,) = struct.unpack("<Q", take(8))
        arrays.append(np.frombuffer(take(nbytes), dt).reshape(shape).copy())
    return tag, arrays


class HeterServer:
    """Serves registered callables to HeterClients.

    ``register(name, fn)`` exposes ``fn(*arrays) -> array | tuple`` (a
    "section" of the step; it may return torch tensors).
    Loopback bind by default; the protocol is unauthenticated (same trust
    model as the PS transport) but carries only a restricted
    dtype/shape/bytes array encoding — never pickled objects."""

    def __init__(self):
        self._fns: Dict[str, object] = {}
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.port = None

    def register(self, name: str, fn):
        self._fns[name] = fn

    def start(self, port=0, host="127.0.0.1"):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        self._running = False
        if self._sock is not None:
            try:  # wakes the accept() a close alone leaves blocked
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- internals ----------------------------------------------------------
    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while self._running:
                hdr = self._read_full(conn, 4)
                if hdr is None:
                    return
                (ln,) = struct.unpack("<I", hdr)
                if ln > (1 << 30):
                    return
                body = self._read_full(conn, ln)
                if body is None:
                    return
                try:
                    name, arrays = _dec_arrays(body)
                    fn = self._fns[name]
                    out = fn(*arrays)
                    if not isinstance(out, (list, tuple)):
                        out = (out,)
                    resp = _enc_arrays("ok", list(out))
                except Exception as e:  # noqa: BLE001 — shipped to caller
                    resp = _enc_arrays(
                        "err:" + str(e)[:500], [])
                conn.sendall(struct.pack("<I", len(resp)) + resp)
        finally:
            conn.close()

    @staticmethod
    def _read_full(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf


class HeterClient:
    """Worker-side handle: ``run(name, *arrays)`` executes the named
    section on the heter server and returns its output arrays."""

    def __init__(self, host="127.0.0.1", port=0):
        self._sock = socket.create_connection((host, port))

    def run(self, name: str, *arrays):
        payload = _enc_arrays(name, list(arrays))
        self._sock.sendall(struct.pack("<I", len(payload)) + payload)
        hdr = HeterServer._read_full(self._sock, 4)
        if hdr is None:
            raise ConnectionError("heter server closed the connection")
        (ln,) = struct.unpack("<I", hdr)
        body = HeterServer._read_full(self._sock, ln)
        if body is None:
            raise ConnectionError(
                "heter server closed mid-response")
        tag, out = _dec_arrays(body)
        if tag != "ok":
            raise RuntimeError(
                f"heter section {name!r} failed: {tag[4:]}")
        return tuple(out) if len(out) != 1 else out[0]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
