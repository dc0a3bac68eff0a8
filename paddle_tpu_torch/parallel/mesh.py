"""The serving mesh's runtime: worker processes over `torch.distributed`
(no JAX counterpart; the JAX engine is one host program over a mesh of
XLA devices, and GSPMD places its collectives).

The process that builds the engine is the controller, rank 0: it keeps
everything on the host (scheduler, page allocator, block tables, prefix
cache, sampling, journal, telemetry) and computes its own shard of every
layer plus the replicated embedding, final LayerNorm and head.  Ranks
1..N-1 are workers, started once per process and spec by `get_mesh` and
shared by every engine built on that spec.  A worker holds only its
weight shard and its heads of the KV pools, and runs one control message
a step.

* **Start-up.** Each worker is ``python -m paddle_tpu_torch.parallel.mesh``
  (a fresh interpreter that imports this package alone, never the
  caller's ``__main__``), joined through a `torch.distributed.FileStore`
  in a temporary directory, so no port is needed.
* **Two planes.** Control messages go over a pipe pair a worker:
  length-framed pickles, the op and the step's host inputs (block tables,
  lengths, tokens, write caps, the fresh pages whose int8 scales reset).
  A pipe waits as long as an idle engine does, and reads end of file the
  moment its worker dies.  The activations' all-reduces go over a data
  group of the backend below.
* **Backend rule** (`choose_backend`, which data-parallel training's
  `distributed.init_parallel_env` shares; `Mesh.describe` shows it in
  `statusz`): NCCL when every rank has a card of its own
  (``mp <= torch.cuda.device_count()``), gloo when ranks share a card or
  on the CPU.  Rank *i* runs on ``cuda:((c + i) % device_count)``, *c*
  the controller's card, or on the CPU when the controller is there.
  NCCL that fails to start raises: nothing falls back to gloo.  A gloo
  all-reduce of a CUDA tensor is staged through host memory, and a
  step with gloo collectives cannot be a CUDA graph: it runs eagerly.
* **Failure.** A worker that dies closes its pipe and its gloo sockets:
  the controller's next message or collective raises `MeshError` at
  once (a worker is killed at its first exception, so a fault never
  leaves the others waiting).  A worker that stays alive but silent
  raises at ``MESH_TIMEOUT_S``.  A broken mesh is replaced, workers
  killed, at the next `get_mesh` of its spec.
* **Lifetime.** An engine's `MeshShards` frees its state on the workers
  when the engine lets go of it; the mesh shuts its workers down at
  exit (`atexit`).
"""
from __future__ import annotations

import atexit
import datetime
import os
import pickle
import select
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Mesh", "MeshShards", "MeshError", "get_mesh", "shutdown_all",
           "rank_capacity", "choose_backend", "MESH_TIMEOUT_S"]

# seconds a live worker may stay silent (a reply, a collective) before
# the controller gives up on it; a dead one raises at once
MESH_TIMEOUT_S = 120.0

_HDR = struct.Struct("<Q")


class MeshError(RuntimeError):
    """A mesh worker was lost (died, or stayed silent past
    ``MESH_TIMEOUT_S``): the mesh can serve no further step.  Never
    contained by the resilience ladder: no retry brings a rank back."""


# ---------------------------------------------------------------------------
# framing (both ends)
# ---------------------------------------------------------------------------
def _write(fd: int, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(_HDR.pack(len(data)) + data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _read_exact(fd: int, n: int, deadline=None, alive=None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("no reply")
                r, _, _ = select.select([fd], [], [], min(left, 0.5))
                if r:
                    break
                if alive is not None and not alive():
                    raise EOFError("worker exited")
        chunk = os.read(fd, min(n - len(buf), 1 << 24))
        if not chunk:
            raise EOFError("pipe closed")
        buf += chunk
    return bytes(buf)


def _read(fd: int, deadline=None, alive=None):
    (n,) = _HDR.unpack(_read_exact(fd, _HDR.size, deadline, alive))
    return pickle.loads(_read_exact(fd, n, deadline, alive))


def choose_backend(device: torch.device, ranks: int) -> str:
    """The port's backend rule, for the serving mesh and for data-parallel
    training alike: "nccl" when the ranks run on CUDA and each has a card
    of its own (``ranks <= torch.cuda.device_count()``), "gloo" when they
    share a card or run on the CPU."""
    if torch.device(device).type == "cuda" and \
            ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _make_group(backend: str, store, rank: int, size: int):
    import torch.distributed as dist

    td = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = td
        return dist.ProcessGroupGloo(store, rank, size, opts)
    opts = dist.ProcessGroupNCCL.Options()
    if hasattr(opts, "_timeout"):
        opts._timeout = td
    return dist.ProcessGroupNCCL(store, rank, size, opts)


def _all_reduce(group, backend: str, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the group, in place.  A gloo group stages a CUDA
    tensor through host memory."""
    from ..observability.costmodel import active_tally

    tally = active_tally()
    with (tally.pause() if tally is not None else _NULL):
        if backend == "gloo" and t.is_cuda:
            h = t.cpu()
            group.allreduce([h]).wait()
            t.copy_(h)
        else:
            group.allreduce([t]).wait()
    return t


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def rank_capacity() -> int:
    """The most ranks a mesh places: each rank is a process that drives
    its shard from a CPU core of its own, so the cores this process may
    run on, whatever the device (ranks share cards round-robin)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


def _foreign_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))


# ---------------------------------------------------------------------------
# the controller's side
# ---------------------------------------------------------------------------
class Mesh:
    """``mp`` ranks over one spec: the controller (this process, rank 0,
    on ``device``) and ``mp - 1`` worker processes.  ``backend`` and
    ``devices`` follow the rule of the module docstring; ``capturable``
    says whether a sharded step may be a CUDA graph (NCCL)."""

    def __init__(self, spec: str, device):
        from .partition import parse_mesh_spec

        axes = parse_mesh_spec(spec)
        if [a for a, _ in axes] != ["mp"]:
            raise ValueError(
                f"the serving mesh has a single tensor-parallel axis "
                f"'mp=N', got {spec!r}")
        self.mp = mp = axes[0][1]
        self.spec = f"mp={mp}"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            count = torch.cuda.device_count()
            first = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            self.device = torch.device("cuda", first)
            self.devices = [torch.device("cuda", (first + i) % count)
                            for i in range(mp)]
        else:
            self.devices = [torch.device("cpu")] * mp
        self.backend = choose_backend(self.device, mp)
        self.capturable = self.backend == "nccl"
        self.broken: Optional[str] = None
        self.lock = threading.RLock()
        self._next_hid = 0
        self._closing: List[int] = []  # handles released since the last op
        # the controller's step trackers whose CUDA graphs captured this
        # mesh's collectives (`track_graphs`)
        self._graph_steps = weakref.WeakSet()
        self._procs: List[subprocess.Popen] = []
        self._tx: List[int] = []
        self._rx: List[int] = []
        self.foreign_modules: Dict[int, List[str]] = {}
        self._dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_mesh_")
        try:
            self._start()
        except BaseException:
            self.shutdown()
            raise

    def describe(self) -> dict:
        """The backend, the placement and why (statusz's ``mesh``)."""
        return {"spec": self.spec, "ranks": self.mp,
                "backend": self.backend,
                "rule": "nccl when every rank has a card of its own, "
                        "gloo when ranks share a card or on the cpu",
                "placement": [str(d) for d in self.devices],
                "captured_steps": self.capturable,
                "workers": [p.pid for p in self._procs],
                "broken": self.broken}

    def _start(self):
        import torch.distributed as dist

        store_path = os.path.join(self._dir, "store")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
        # a CPU mesh runs the tests' tiny shapes: a thread a worker keeps
        # its ranks from crowding the cores they share
        threads = 1 if self.device.type == "cpu" else \
            max(1, torch.get_num_threads() // self.mp)
        for rank in range(1, self.mp):
            c_r, w_w = os.pipe()   # controller -> worker
            w_r, c_w = os.pipe()   # worker -> controller
            p = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.parallel.mesh",
                 store_path, str(rank), str(self.mp),
                 str(self.devices[rank]), self.backend, str(c_r),
                 str(c_w), str(threads)],
                pass_fds=(c_r, c_w), env=env, close_fds=True)
            os.close(c_r)
            os.close(c_w)
            self._procs.append(p)
            self._tx.append(w_w)
            self._rx.append(w_r)
        for rank in range(1, self.mp):
            self.foreign_modules[rank] = self._recv(rank, "hello")
        store = dist.FileStore(store_path, self.mp)
        self._data = _make_group(self.backend,
                                 dist.PrefixStore("data", store), 0,
                                 self.mp)
        for rank in range(1, self.mp):
            self._recv(rank, "joined")
        # one collective now: a group that cannot reduce fails here, at
        # construction, and NCCL's communicator exists before any capture
        probe = torch.ones(1, device=self.devices[0])
        self.all_reduce(probe)
        if int(probe.item()) != self.mp:
            raise MeshError(f"mesh {self.spec}: a test all-reduce gave "
                            f"{probe.item()}, not {self.mp}")

    # -- failure -----------------------------------------------------------
    def _alive(self, rank: int) -> bool:
        return self._procs[rank - 1].poll() is None

    def _lost(self, rank: Optional[int], err: BaseException) -> MeshError:
        dead = [r for r in range(1, self.mp) if not self._alive(r)]
        who = f"worker rank {dead[0]} exited with code " \
              f"{self._procs[dead[0] - 1].returncode}" if dead else \
            (f"worker rank {rank} is silent" if rank is not None else
             "a collective failed")
        self.broken = self.broken or f"{who}: {err}"
        return MeshError(f"mesh {self.spec} lost: {who} ({err})")

    def usable(self) -> bool:
        return self.broken is None and \
            all(self._alive(r) for r in range(1, self.mp))

    def _check(self):
        if self.broken is not None:
            raise MeshError(f"mesh {self.spec} is broken: {self.broken}")

    # -- the control plane -------------------------------------------------
    def _send(self, rank: int, msg) -> None:
        try:
            _write(self._tx[rank - 1], msg)
        except OSError as e:
            raise self._lost(rank, e) from e

    def _recv(self, rank: int, want: str, timeout: float = MESH_TIMEOUT_S):
        """The next reply of ``rank`` tagged ``want``; stale replies of
        another tag (a probe stamp nobody read) are dropped."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                msg = _read(self._rx[rank - 1], deadline,
                            lambda: self._alive(rank))
            except (OSError, EOFError, TimeoutError) as e:
                raise self._lost(rank, e) from e
            if msg[0] == want:
                return msg[1]

    def _flush_closing(self):
        while self._closing:
            hid = self._closing.pop()
            for r in range(1, self.mp):
                self._send(r, ("close", hid))

    def _release(self, hid: int):
        """A `MeshShards` died: its workers' state goes with the next
        message (a finalizer must not write a pipe another message may
        be half way through)."""
        self._closing.append(hid)

    def _broadcast(self, msg):
        with self.lock:
            self._check()
            self._flush_closing()
            for r in range(1, self.mp):
                self._send(r, msg)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sharded step's reduction: ``t`` summed over the ranks, in
        place (each rank's row-split product, or its refold count)."""
        self._check()
        try:
            # a named range, for a profile's share of the step in reduces
            with torch.profiler.record_function("mesh.all_reduce"):
                return _all_reduce(self._data, self.backend, t)
        except RuntimeError as e:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise
            raise self._lost(None, e) from e

    # -- engines -----------------------------------------------------------
    def open(self, shards: List[dict], cfg: dict) -> "MeshShards":
        """Hand each worker its shard (``shards[r - 1]`` for rank r, host
        tensors) and the pool geometry ``cfg``; returns the engine's
        handle."""
        with self.lock:
            self._check()
            self._flush_closing()
            hid = self._next_hid
            self._next_hid += 1
            for r in range(1, self.mp):
                self._send(r, ("open", hid, shards[r - 1], cfg))
            for r in range(1, self.mp):
                self._recv(r, "opened")
        return MeshShards(self, hid)

    def request(self, op: str, *args) -> List[object]:
        """One control op every worker answers (``"stats"``,
        ``"gather"``): the replies in rank order."""
        with self.lock:
            self._broadcast((op, *args))
            return [self._recv(r, op) for r in range(1, self.mp)]

    def stats(self, reset: bool = False) -> List[dict]:
        """Each worker's kernel launch counters, graphs and foreign
        modules (rank order); ``reset`` zeroes the counters after the
        read."""
        return self.request("stats", reset)

    def track_graphs(self, step):
        """Note a step tracker (`serving._MeshStep`) whose CUDA graphs
        capture this mesh's collectives: `shutdown` destroys them before
        the communicator."""
        self._graph_steps.add(step)

    # -- shutdown ----------------------------------------------------------
    def shutdown(self):
        """Stop every worker (an exit message, then a kill after a grace
        period), destroy the CUDA graphs that captured an NCCL
        communicator's collectives, abort it and remove the store."""
        for r, p in enumerate(self._procs, start=1):
            if p.poll() is None:
                try:
                    _write(self._tx[r - 1], ("exit",))
                except OSError:
                    pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for fd in self._tx + self._rx:
            try:
                os.close(fd)
            except OSError:
                pass
        self._tx, self._rx = [], []
        self.broken = self.broken or "shut down"
        group, self._data = getattr(self, "_data", None), None
        if self.backend == "nccl" and group is not None:
            # NCCL tears a communicator down only after the CUDA graphs
            # that captured its collectives: with one alive the abort, and
            # the process's exit, hang (seen on four cards)
            for step in list(self._graph_steps):
                step.release_graphs()
            torch.cuda.synchronize(self.device)
            # the other ranks are gone: release NCCL's communicator without
            # waiting on them (a graceful finalize may wait for peers)
            try:
                group.abort()
            except Exception:
                pass
        shutil.rmtree(self._dir, ignore_errors=True)

    @property
    def workers(self) -> List[subprocess.Popen]:
        return list(self._procs)


class MeshShards:
    """One engine's state on the mesh's workers (their weight shards and
    pools), and the per-step state its sharded steps send: the pages
    whose int8 scales reset, whether the dispatch is probed, and the
    controller's probe stamps.  Handed over with the engine's graphs at
    a recovery; the workers free the state when the last reference to
    it goes."""

    def __init__(self, mesh: Mesh, hid: int):
        self.mesh = mesh
        self.hid = hid
        self.fresh: List[np.ndarray] = []
        self.probe = False
        self.probes_sent = 0
        self.stamps: List[float] = []
        weakref.finalize(self, mesh._release, hid)

    def step(self, kind: str, host, eager: bool):
        """Send one sharded step (its kind and host inputs) to every
        worker; the caller then runs rank 0's shard."""
        fresh, self.fresh = self.fresh, []
        probe, self.probe = self.probe, False
        self.mesh._broadcast(("step", self.hid, kind, host, fresh, probe,
                              eager))
        self.probes_sent += int(probe)

    def stamp(self):
        """Rank 0's stamp: its probed step's output reached the host."""
        if len(self.stamps) < self.probes_sent:
            self.stamps.append(time.monotonic())

    def skews(self) -> List[float]:
        """Completion skew (max minus min of the ranks' monotonic stamps)
        of each probed step since the last call."""
        out = []
        n, self.probes_sent = self.probes_sent, 0
        own, self.stamps = self.stamps, []
        for i in range(n):
            ts = [self.mesh._recv(r, "stamp")
                  for r in range(1, self.mesh.mp)]
            ts.append(own[i] if i < len(own) else time.monotonic())
            out.append(max(ts) - min(ts))
        return out

    def zero(self):
        self.mesh._broadcast(("zero", self.hid))

    def gather(self, ids: np.ndarray) -> List[dict]:
        """Each worker's heads of pages ``ids`` (numpy, rank order)."""
        return self.mesh.request("gather", self.hid, ids)

    def put(self, ids: np.ndarray, per_rank: List[dict]):
        """Write each worker its heads of pages ``ids``."""
        with self.mesh.lock:
            self.mesh._check()
            for r in range(1, self.mesh.mp):
                self.mesh._send(r, ("put", self.hid, ids, per_rank[r - 1]))
            for r in range(1, self.mesh.mp):
                self.mesh._recv(r, "put")


_MESHES: Dict[tuple, Mesh] = {}
_MESHES_LOCK = threading.Lock()


def get_mesh(spec: str, device=None) -> Mesh:
    """The process's mesh for ``spec`` on ``device`` (the controller's;
    None = the card): built at the first call and shared after, rebuilt
    when the cached one is broken."""
    from ..device import resolve_device
    from .partition import parse_mesh_spec

    dev = resolve_device(device)
    norm = ",".join(f"{a}={n}" for a, n in parse_mesh_spec(spec))
    key = (norm, str(dev))
    with _MESHES_LOCK:
        m = _MESHES.get(key)
        if m is not None and m.usable():
            return m
        if m is not None:
            m.shutdown()
        m = _MESHES[key] = Mesh(norm, dev)
        return m


def shutdown_all():
    """Stop every mesh of the process (registered at exit)."""
    with _MESHES_LOCK:
        meshes = list(_MESHES.values())
        _MESHES.clear()
    for m in meshes:
        m.shutdown()


atexit.register(shutdown_all)


# ---------------------------------------------------------------------------
# the worker's side
# ---------------------------------------------------------------------------
class _Shard:
    """One engine's state on a worker: its weight shard, its heads of the
    KV pools and the step graphs over them."""

    def __init__(self, params: dict, cfg: dict, device, reduce,
                 capturable: bool):
        from ..inference import serving as S

        def to(t):
            return None if t is None else t.to(device)

        self.params = {k: to(v) for k, v in params.items()
                       if k != "blocks"}
        self.params["blocks"] = [{k: to(v) for k, v in b.items()}
                                 for b in params["blocks"]]
        shape = S._pool_shape(cfg["layers"], cfg["heads"], cfg["pages"],
                              cfg["page"], cfg["head_dim"])
        dtype = getattr(torch, cfg["kv_dtype"])
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.ks = self.vs = None
        self.kw = dict(num_heads=cfg["heads"], head_dim=cfg["head_dim"],
                       eps=cfg["eps"], reduce=reduce)
        if cfg["kv_quant"]:
            self.ks = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
            self.vs = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
            self.kw.update(k_scales=self.ks, v_scales=self.vs)
        self.device = device
        self.capturable = capturable
        self.memory = S._GraphMemory()
        self.fns: Dict[str, object] = {}
        self.reset_fn = None

    def tracker(self, kind: str):
        from ..inference import serving as S

        fn = self.fns.get(kind)
        if fn is None:
            step = S._MESH_WORKER_STEPS[kind]
            p, k, v, kw = self.params, self.k, self.v, self.kw

            @torch.no_grad()
            def run(*inputs):
                step(p, k, v, *inputs, **kw)

            fn = self.fns[kind] = S._StepGraph(
                run, f"{kind}_compiles", self.device, self.memory,
                capture=self.capturable)
        return fn

    def run(self, kind, host, fresh, probe, eager, reply):
        from ..inference import serving as S

        ctx = S.disable_capture() if eager else _NULL
        with ctx:
            for buf in fresh:
                if self.reset_fn is None:
                    self.reset_fn = S._scale_reset_graph(
                        self.ks, self.vs, self.device, self.memory)
                self.reset_fn(buf)
            self.tracker(kind)(*host)
        if probe:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            reply(("stamp", time.monotonic()))

    def gather(self, ids):
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        out = {"k": self.k.index_select(2, idx).cpu().numpy(),
               "v": self.v.index_select(2, idx).cpu().numpy()}
        if self.ks is not None:
            out["ks"] = self.ks.index_select(2, idx).cpu().numpy()
            out["vs"] = self.vs.index_select(2, idx).cpu().numpy()
        return out

    def put(self, ids, arrays):
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        for name, dst in (("k", self.k), ("v", self.v), ("ks", self.ks),
                          ("vs", self.vs)):
            if dst is not None and name in arrays:
                dst.index_copy_(2, idx, torch.from_numpy(
                    np.ascontiguousarray(arrays[name])).to(self.device))

    def zero(self):
        for t in (self.k, self.v, self.ks, self.vs):
            if t is not None:
                t.zero_()


def _worker_main(argv: List[str]) -> int:
    import torch.distributed as dist

    store_path, rank, size, device, backend, rfd, wfd, threads = argv
    rank, size, rfd, wfd = int(rank), int(size), int(rfd), int(wfd)
    device = torch.device(device)
    torch.set_num_threads(int(threads))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    from ..core import flags as _flags
    from ..ops import paged_attention as pa

    # a worker counts no cost profiles: the controller's telemetry does
    _flags.set_flags({"cost_model": False})

    def reply(msg):
        _write(wfd, msg)

    reply(("hello", _foreign_modules()))
    store = dist.FileStore(store_path, size)
    data = _make_group(backend, dist.PrefixStore("data", store), rank, size)
    reply(("joined", rank))
    probe = torch.ones(1, device=device)
    _all_reduce(data, backend, probe)

    def reduce(t):
        return _all_reduce(data, backend, t)

    shards: Dict[int, _Shard] = {}
    wrappers = {"K1": pa.paged_attention_cuda, "K2": pa.paged_attention_cuda_q}
    while True:
        try:
            msg = _read(rfd)
        except EOFError:
            return 0  # the controller is gone
        op = msg[0]
        if op == "step":
            _, hid, kind, host, fresh, probe_on, eager = msg
            shards[hid].run(kind, host, fresh, probe_on, eager, reply)
        elif op == "open":
            _, hid, params, cfg = msg
            shards[hid] = _Shard(params, cfg, device, reduce,
                                 backend == "nccl")
            reply(("opened", hid))
        elif op == "close":
            shards.pop(msg[1], None)
        elif op == "zero":
            shards[msg[1]].zero()
        elif op == "gather":
            reply(("gather", shards[msg[1]].gather(msg[2])))
        elif op == "put":
            shards[msg[1]].put(msg[2], msg[3])
            reply(("put", msg[1]))
        elif op == "stats":
            out = {"rank": rank, "pid": os.getpid(),
                   "launches": {k: w.launches for k, w in wrappers.items()},
                   "graphs": sum(f.captures for s in shards.values()
                                 for f in s.fns.values()),
                   "engines": len(shards),
                   "foreign_modules": _foreign_modules()}
            if msg[1]:
                for w in wrappers.values():
                    w.launches = 0
            reply(("stats", out))
        elif op == "exit":
            return 0


if __name__ == "__main__":
    try:
        code = _worker_main(sys.argv[1:])
    except BaseException:
        # a failed worker dies, closing its pipe and sockets: the
        # controller raises at its next message or collective instead of
        # waiting on a rank that will never reduce
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(code)
