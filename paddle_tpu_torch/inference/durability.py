"""Durable serving: a write-ahead request journal and on-disk snapshots
that survive process death, graph handoff for in-process rebuilds, and
a hung-step watchdog (counterpart: paddle_tpu/inference/durability.py).

* **Process death.**  With ``FLAGS_journal_dir`` armed, every admission,
  emitted-token watermark and finish is appended to a crc-framed
  write-ahead journal (``journal.wal``, fsync policy
  ``FLAGS_journal_fsync``), and every ``FLAGS_snapshot_interval_steps``
  steps the engine's host state goes atomically to ``snapshot.json``
  (with ``FLAGS_snapshot_kv`` the prefix-cached KV pages, int8 with
  their scales under ``kv_quant``, to ``kv_pages.npz``).
  `restore_from_dir` rebuilds the engine in a fresh process and
  re-admits every request through the replay fold: greedy outputs are
  bit-identical and the streamed watermark keeps a token a previous
  life streamed from firing again.
* **Handoff.**  `resilience.recover` hands a dead engine's captured
  CUDA graphs, with the tensors they read, to its rebuilt successor
  (`DecodeEngine._take_over`).  A fresh process
  captures anew: a CUDA graph cannot be serialized, so JAX's persistent
  compile cache (``FLAGS_compile_cache_dir``) has no counterpart yet.
* **Hung steps.**  `StepWatchdog` (``FLAGS_step_timeout_ms``) classifies
  a step over its budget that captured and compiled nothing as hung,
  flips the ``paddle_engine_health`` gauge and raises a fatal
  `errors.HungStep`; `frontend.ServingFrontend` also abandons a worker
  still stuck past the budget.

The journal, snapshot and sidecar keep the JAX package's bytes: the same
record keys, crc framing, file names and npz keys, so either package
reads the other's directory.  A snapshot of a sampling engine adds one
key, ``rng`` (the generator state), which JAX's reader ignores.  The
telemetry plane's constructor keys (flight recorder, cost model and its
calibration, profiling, alerts) restore with the rest of the config, a
snapshot carries the cost model's calibration, and a restore or an
adoption lands as an event in the engine's flight record.  With ``FLAGS_journal_dir`` unset and
``FLAGS_step_timeout_ms`` zero, every hook is one ``is None`` check.
"""
from __future__ import annotations

import itertools
import json
import os
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import observability as _obs
from .errors import FaultInfo, HungStep
from .serving import _dtype_name, _EngineRef

__all__ = ["RequestWire", "SnapshotWire", "DurabilityManager",
           "StepWatchdog", "read_journal", "load_snapshot",
           "restore_from_dir", "adopt_from_dir", "compact_journal",
           "set_health", "clear_health", "retire_engine_series",
           "HEALTH_STATES", "JOURNAL_NAME", "SNAPSHOT_NAME",
           "KV_PAGES_NAME"]


def _engine_kwargs(cfg: dict) -> dict:
    """The port engine's keyword arguments from a journal's config
    record (either package's): the same keys, a mesh spec included (a
    sharded journal rebuilds a sharded engine)."""
    kw = dict(cfg)
    if kw.get("serve_mesh") is None:
        kw.pop("serve_mesh", None)
    return kw


JOURNAL_NAME = "journal.wal"
SNAPSHOT_NAME = "snapshot.json"
# FLAGS_snapshot_kv sidecar: the content-addressed (prefix-cached) KV
# page payloads — int8 + scales under FLAGS_kv_quant — serialized
# beside the snapshot so a restore installs them instead of
# recomputing the whole prompt history (see DurabilityManager)
KV_PAGES_NAME = "kv_pages.npz"


# ---------------------------------------------------------------------------
# Record framing: every journal record (and the snapshot file) is
# "<crc32 hex8> <compact json>\n" — a torn write fails the crc (or has
# no terminator) and the reader stops at the last consistent record
# instead of crashing or trusting garbage.
# ---------------------------------------------------------------------------
def _frame(obj: dict) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    return b"%08x %s\n" % (zlib.crc32(payload), payload)


def _parse_frames(data: bytes) -> Tuple[List[dict], int]:
    """(records, valid_byte_length): decode crc-framed lines, stopping
    at the first torn/corrupt one — everything before it is the last
    consistent state, everything after it is untrusted."""
    events: List[dict] = []
    pos = 0
    while pos < len(data):
        nl = data.find(b"\n", pos)
        if nl < 0:
            break  # unterminated tail record: torn write
        line = data[pos:nl]
        try:
            crc_hex, payload = line.split(b" ", 1)
            if int(crc_hex, 16) != zlib.crc32(payload):
                break
            events.append(json.loads(payload))
        except Exception:
            break
        pos = nl + 1
    return events, pos


def read_journal(path: str) -> Tuple[List[dict], int]:
    """All consistent records of a journal file plus the byte offset
    the last one ends at (a reopening writer truncates to it).  A
    missing file is an empty journal."""
    if not os.path.exists(path):
        return [], 0
    with open(path, "rb") as f:
        return _parse_frames(f.read())


# ---------------------------------------------------------------------------
# Wire forms.  `resilience.EngineSnapshot` holds live `Request` objects
# BY REFERENCE — correct in-process (streams/hooks survive a rebuild),
# wrong on disk (callbacks, engine backrefs and ns timestamps are not
# serializable state).  The wire form is the picklable/JSON-able split:
# original prompt, full generated values, original budget, and the
# streamed watermark — everything a fresh process needs to re-admit the
# request through the replay fold.
# ---------------------------------------------------------------------------
@dataclass
class RequestWire:
    """Serialization-safe form of one in-flight request.

    ``prompt`` is the ORIGINAL prompt (pre any preemption fold) and
    ``max_new`` the ORIGINAL budget, so the wire form is stable no
    matter how many times the live request was preempted or recovered.
    ``streamed`` is the emitted-token watermark: how many generated
    tokens a consumer has already seen — `materialize` turns the
    excess over ``len(generated)`` into an ``_emit_gate`` so replay
    recomputes those tokens without ever re-firing ``on_token``."""

    request_id: int
    prompt: List[int]
    generated: List[int]
    max_new: int
    streamed: int
    eos: Optional[int] = None
    priority: Optional[int] = None
    deadline_ms: Optional[float] = None
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    # fleet-scope trace id (observability.fleettrace): persisted so a
    # failover adoption keeps the donor's trace — the one piece of
    # request identity that must survive the process boundary
    trace: Optional[str] = None

    @classmethod
    def from_request(cls, req) -> "RequestWire":
        gen = list(req.generated_ids)
        return cls(
            request_id=req.request_id,
            prompt=list(req.prompt_ids[:req.orig_prompt_len]),
            generated=gen,
            max_new=req.max_new_tokens + req._absorbed,
            streamed=len(gen) + req._emit_gate,
            eos=req.eos_token_id, priority=req.priority,
            deadline_ms=req.deadline_ms, slo_ttft_ms=req.slo_ttft_ms,
            slo_tpot_ms=req.slo_tpot_ms,
            trace=getattr(req, "trace_id", None))

    @classmethod
    def from_record(cls, rec) -> "RequestWire":
        """From a `resilience._ReqRecord` (state AT CAPTURE, not the
        live request, which may have advanced since)."""
        req = rec.request
        gen = list(rec.prompt_ids[rec.orig_len:]) + list(rec.output_ids)
        return cls(
            request_id=req.request_id,
            prompt=list(rec.prompt_ids[:rec.orig_len]),
            generated=gen,
            max_new=rec.max_new + rec.absorbed,
            streamed=rec.streamed,
            eos=req.eos_token_id, priority=req.priority,
            deadline_ms=req.deadline_ms, slo_ttft_ms=req.slo_ttft_ms,
            slo_tpot_ms=req.slo_tpot_ms,
            trace=getattr(req, "trace_id", None))

    def to_obj(self) -> dict:
        obj = {"id": self.request_id, "p": self.prompt,
               "g": self.generated, "mn": self.max_new,
               "sm": self.streamed, "eos": self.eos,
               "pr": self.priority, "dl": self.deadline_ms,
               "tt": self.slo_ttft_ms, "tp": self.slo_tpot_ms}
        if self.trace is not None:
            # conditional so pre-fleet-trace journals stay byte-stable
            obj["tr"] = self.trace
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "RequestWire":
        return cls(request_id=int(obj["id"]), prompt=list(obj["p"]),
                   generated=list(obj["g"]), max_new=int(obj["mn"]),
                   streamed=int(obj["sm"]), eos=obj.get("eos"),
                   priority=obj.get("pr"), deadline_ms=obj.get("dl"),
                   slo_ttft_ms=obj.get("tt"), slo_tpot_ms=obj.get("tp"),
                   trace=obj.get("tr"))

    def materialize(self):
        """A fresh `Request` carrying this wire state, re-admittable
        through the replay fold: generated tokens folded into the
        prompt (budget shrinks one for one), the streamed watermark
        turned into an emit gate, the original request id restored."""
        from .serving import Request

        req = Request(
            list(self.prompt) + list(self.generated),
            max_new_tokens=self.max_new - len(self.generated),
            eos_token_id=self.eos, priority=self.priority,
            deadline_ms=self.deadline_ms, slo_ttft_ms=self.slo_ttft_ms,
            slo_tpot_ms=self.slo_tpot_ms)
        req.orig_prompt_len = len(self.prompt)
        req._absorbed = len(self.generated)
        req._emit_gate = max(0, self.streamed - len(self.generated))
        req.request_id = self.request_id
        if self.trace is not None:
            req.trace_id = self.trace
        return req


@dataclass
class SnapshotWire:
    """Serialization-safe form of a whole `EngineSnapshot`:
    ``journal_pos`` anchors it in the journal (replay resumes at that
    record index), the RNG fold counters carry the sampling streams,
    and ``records`` hold every in-flight request in admission order."""

    engine_id: int
    step_no: int
    prefill_no: int
    journal_pos: int
    records: List[RequestWire] = field(default_factory=list)
    # FLAGS_snapshot_kv: metadata anchoring the kv_pages sidecar —
    # file name, crc of its bytes, chain hashes (hex) in array order,
    # and the storage dtype.  None = no sidecar (flag off, no cached
    # pages, or a pre-sidecar snapshot); restore then recomputes
    kv: Optional[dict] = None
    # cost-observatory calibration (observability.costmodel): the
    # per-executable EWMA factors as of the snapshot, so a restored
    # engine predicts step cost warm instead of re-learning from 1.0.
    # None = pre-observatory snapshot or cost model off
    cost: Optional[dict] = None
    # the sampling generator's state (hex of `torch.Generator.get_state`)
    # of an engine that samples; None for greedy, whose snapshot bytes
    # are then the JAX package's.  JAX readers ignore the key.
    rng: Optional[str] = None

    def to_obj(self) -> dict:
        obj = {"v": 1, "engine_id": self.engine_id,
               "step_no": self.step_no, "prefill_no": self.prefill_no,
               "journal_pos": self.journal_pos,
               "records": [r.to_obj() for r in self.records]}
        if self.kv is not None:
            obj["kv"] = self.kv
        if self.cost is not None:
            obj["cost"] = self.cost
        if self.rng is not None:
            obj["rng"] = self.rng
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "SnapshotWire":
        return cls(engine_id=int(obj["engine_id"]),
                   step_no=int(obj["step_no"]),
                   prefill_no=int(obj["prefill_no"]),
                   journal_pos=int(obj["journal_pos"]),
                   records=[RequestWire.from_obj(r)
                            for r in obj["records"]],
                   kv=obj.get("kv"), cost=obj.get("cost"),
                   rng=obj.get("rng"))


def load_snapshot(journal_dir: str) -> Optional[SnapshotWire]:
    """The on-disk snapshot, or None when absent OR torn/corrupt — a
    restore then falls back to replaying the whole journal (the last
    consistent state is never worse than no snapshot)."""
    path = os.path.join(journal_dir, SNAPSHOT_NAME)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        records, _ = _parse_frames(f.read())
    if len(records) != 1:
        return None  # torn/corrupt snapshot: journal-only restore
    try:
        return SnapshotWire.from_obj(records[0])
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Engine health (the watchdog's gauge).  One-hot per engine so a
# dashboard can alert on `paddle_engine_health{state="hung"} == 1`;
# every transition also lands as a `health:*` engine span so the
# sequence (live -> hung -> recovering -> live) is reconstructable.
# ---------------------------------------------------------------------------
HEALTH_STATES = ("live", "degraded", "recovering", "hung")

# current state per engine id: set_health only touches the series a
# transition actually involves (a healthy engine is ONE series, not
# four — engine ids are unbounded and the registry caps cardinality)
_health_state: Dict[int, str] = {}


def set_health(engine_id: int, state: str, span: bool = True):
    """Flip one engine's ``paddle_engine_health`` gauge.  ``span=False``
    records the INITIAL state at construction without a transition
    span, so the span stream reads as the actual transition sequence
    (live -> hung -> recovering -> live) with no construction blips."""
    if state not in HEALTH_STATES:
        raise ValueError(f"unknown health state {state!r}")
    prev = _health_state.get(engine_id)
    if prev == state:
        return
    _health_state[engine_id] = state
    if prev is not None:
        _obs.ENGINE_HEALTH.set(0, engine=engine_id, state=prev)
    _obs.ENGINE_HEALTH.set(1, engine=engine_id, state=state)
    if span:
        _obs.record_span("engine", f"health:{state}", _obs.now_ns(), 0,
                         tid=engine_id)


def clear_health(engine_id: int):
    """Retire an engine from the health gauge: its last state series
    drops to 0 and no state reads 1.  Recovery calls this for the DEAD
    engine — without it a successfully recovered hang would leave
    ``paddle_engine_health{state="hung"} == 1`` (the documented alert
    condition) latched forever on the retired id."""
    prev = _health_state.pop(engine_id, None)
    if prev is not None:
        _obs.ENGINE_HEALTH.set(0, engine=engine_id, state=prev)


def retire_engine_series(engine_id: int) -> int:
    """Retire a DEAD engine's ENTIRE per-engine gauge catalog — the
    whole-catalog generalization of `clear_health`: pool/occupancy/
    queue gauges, degraded-mode and health one-hots, flight
    throughput/goodput/burn gauges.  `resilience.recover` calls this
    for the engine it replaced and `DecodeEngine._abandon_inflight`
    for the engine the watchdog abandoned, so a retired engine id
    leaves the scrape surface (and `statusz` output) instead of
    reading stale levels forever.  The engine also leaves the ops
    registry (`/statusz`, `/healthz`, `/readyz`) and the profiling
    plane's capture registry (an in-flight capture's trace stops).
    Returns the series count removed."""
    clear_health(engine_id)
    from ..observability import opsserver, profiling

    opsserver.deregister_engine(engine_id)
    profiling.deregister(engine_id)
    return _obs.registry.retire_label("engine", engine_id)


# ---------------------------------------------------------------------------
# The write-ahead journal + periodic snapshots
# ---------------------------------------------------------------------------
class DurabilityManager:
    """Owns one engine's journal file and snapshot cadence.

    Record types (crc-framed JSON lines):

    * ``cfg`` — written once when the journal is created: the engine's
      serializable constructor config + config fingerprint (restore
      validates the rebuilding model against it);
    * ``a`` — admission: the request's identity + prompt + budget;
    * ``e`` — emitted-token watermark: total generated tokens the
      stream has consumed for one request.  WRITE-AHEAD: appended (and,
      under ``journal_fsync=always``, fsynced) BEFORE the ``on_token``
      callback fires, so a token the consumer saw is always covered by
      a durable watermark — restore can suppress it, never re-emit it;
    * ``f`` — finish: request id + finish reason.

    Thread discipline: every hook runs on the thread driving the
    engine (the engine is single-threaded by contract; the frontend
    applies control between steps), so the buffer needs no lock.
    Reopening an existing journal truncates a torn tail record first —
    appends after a crash stay parseable."""

    engine = _EngineRef()

    def __init__(self, engine, journal_dir: str, fsync=None,
                 snapshot_interval=None, snapshot_kv=None):
        from ..core import flags as _flags

        self.engine = engine
        self.journal_dir = str(journal_dir)
        os.makedirs(self.journal_dir, exist_ok=True)
        self.snapshot_kv = bool(
            _flags.flag("snapshot_kv") if snapshot_kv is None
            else snapshot_kv)
        self.fsync = str(fsync if fsync is not None
                         else _flags.flag("journal_fsync"))
        if self.fsync not in ("always", "step", "never"):
            raise ValueError(
                f"journal_fsync must be one of always|step|never, got "
                f"{self.fsync!r}")
        self.snapshot_interval = int(
            snapshot_interval if snapshot_interval is not None
            else _flags.flag("snapshot_interval_steps"))
        self.path = os.path.join(self.journal_dir, JOURNAL_NAME)
        events, valid_len = read_journal(self.path)
        self.seq = len(events)
        if os.path.exists(self.path) and \
                os.path.getsize(self.path) > valid_len:
            with open(self.path, "r+b") as f:
                f.truncate(valid_len)
        self._fh = open(self.path, "ab")
        self._buf: List[bytes] = []
        self._steps_since_snapshot = 0
        if self.seq == 0:
            self.append({"t": "cfg", "v": 1,
                         "fp": engine.config_fingerprint().hex(),
                         "cfg": engine.wire_config()})

    # -- record appends ------------------------------------------------------
    def append(self, obj: dict):
        from .serving import _stats_add

        line = _frame(obj)
        self.seq += 1
        _stats_add(journal_records=1)
        if self.fsync == "always":
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        else:
            self._buf.append(line)

    def flush(self):
        if not self._buf:
            return
        self._fh.write(b"".join(self._buf))
        self._buf = []
        self._fh.flush()
        if self.fsync == "step":
            os.fsync(self._fh.fileno())

    # -- engine hooks --------------------------------------------------------
    def on_admit(self, req):
        # journal the ORIGINAL identity (pre-replay-fold prompt,
        # original budget) — identical for a fresh request, and for a
        # MATERIALIZED one (fleet adoption via `admit_restored`) it
        # keeps this journal's own replay correct: the folded prompt
        # would double-count the generated tokens the emitted-token
        # watermark already covers
        eos = req.eos_token_id
        rec = {"t": "a", "id": req.request_id,
               "p": list(req.prompt_ids[:req.orig_prompt_len]),
               "mn": int(req.max_new_tokens + req._absorbed),
               "eos": None if eos is None else int(eos),
               "pr": req.priority, "dl": req.deadline_ms,
               "tt": req.slo_ttft_ms, "tp": req.slo_tpot_ms}
        if getattr(req, "trace_id", None) is not None:
            # fleet trace id rides the admission record (conditional:
            # trace-less journals stay byte-identical) so an adopting
            # engine can stitch donor + adopter spans into one trace
            rec["tr"] = req.trace_id
        self.append(rec)

    def on_emit(self, req):
        # streamed watermark = generated + still-gated (a gated token
        # was streamed by a previous life): monotonic across restores
        self.append({"t": "e", "id": req.request_id,
                     "n": req._absorbed + len(req.output_ids) +
                     req._emit_gate})

    def on_finish(self, req):
        self.append({"t": "f", "id": req.request_id,
                     "r": req.finish_reason})

    def on_step_boundary(self):
        """Between-steps housekeeping (engine idle): flush per the
        fsync policy, write the periodic snapshot."""
        self.flush()
        if self.snapshot_interval > 0:
            self._steps_since_snapshot += 1
            if self._steps_since_snapshot >= self.snapshot_interval:
                self._steps_since_snapshot = 0
                self.write_snapshot()

    def write_snapshot(self):
        """Serialize the engine's between-steps host state atomically:
        write to a temp file, fsync, `os.replace` — a crash mid-write
        leaves the PREVIOUS snapshot intact, never a torn current one.

        With ``FLAGS_snapshot_kv`` (default on) the content-addressed
        KV page payloads write FIRST into their own atomically-replaced
        sidecar; the snapshot record then anchors the sidecar by crc,
        so a crash between the two writes (stale sidecar, new
        snapshot? impossible — snapshot references the NEW crc; new
        sidecar, old snapshot? the old snapshot's crc no longer
        matches) degrades to recompute, never to serving stale KV."""
        from .resilience import EngineSnapshot
        from .serving import _stats_add

        wire = EngineSnapshot(self.engine).to_wire(journal_pos=self.seq)
        if self.engine._cost is not None:
            wire.cost = self.engine._cost.calibration_wire()
        if self.snapshot_kv:
            wire.kv = self._write_kv_sidecar()
        data = _frame(wire.to_obj())
        path = os.path.join(self.journal_dir, SNAPSHOT_NAME)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _stats_add(journal_snapshots=1)

    def _write_kv_sidecar(self) -> Optional[dict]:
        """Gather every content-addressed (prefix-cached) page's K/V
        payload — and its quant scales when the pool is int8
        (FLAGS_kv_quant) — off the device and write them crash-safely
        beside the snapshot.  Returns the anchor metadata the snapshot
        record carries, or None when there is nothing to serialize
        (prefix cache off / no cached pages yet).  Quantized pools
        serialize int8 bytes + f32 scales: roughly a quarter of the
        fp32 sidecar for the same pages — the snapshot-byte and
        restore-I/O halving tools/bench_kv_quant.py pins."""
        import io

        import numpy as np

        eng = self.engine
        if not eng._prefix_cache or not eng.pool._page_hash:
            return None
        if eng._spec is not None and \
                getattr(eng._spec.drafter, "stateful", False):
            # mirror of _install_kv_sidecar's guard: the restore side
            # always refuses a target-pool-only sidecar when a stateful
            # draft-model drafter needs the recompute to repopulate its
            # own cache — don't pay the device fetch + fsync for bytes
            # that can never install
            return None
        items = sorted(eng.pool._page_hash.items())  # (page, hash)
        # every head: a sharded engine gathers its workers' heads
        arrays = eng._kv_gather([p for p, _ in items])
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        path = os.path.join(self.journal_dir, KV_PAGES_NAME)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return {"file": KV_PAGES_NAME, "crc": zlib.crc32(payload),
                "hashes": [h.hex() for _, h in items],
                "dtype": _dtype_name(eng._k_pages.dtype),
                "page": int(eng._page), "bytes": len(payload)}

    def close(self):
        self.flush()
        self._fh.close()


# ---------------------------------------------------------------------------
# Fresh-process restore
# ---------------------------------------------------------------------------
def _install_kv_sidecar(journal_dir: str, snap: SnapshotWire,
                        eng) -> int:
    """Load the snapshot's KV sidecar (FLAGS_snapshot_kv) into the
    rebuilt engine's pool: allocate a page per serialized payload,
    scatter the payloads (and quant scales) into the device arrays,
    and register each page under its chain hash at refcount 0 (parked
    on the eviction LRU, exactly as a warm-but-idle cache would hold
    it).  Replay re-admission then prefix-hits these pages instead of
    recomputing the token history they encode — the payloads ARE the
    dead engine's bytes, so quantized pools restore their int8 values
    and scales exactly.

    Defensive by construction: any anchor mismatch (missing/torn file,
    crc fail, dtype or geometry drift) skips the install and restore
    recomputes everything — never worse than the pre-sidecar behavior.
    Returns the number of pages installed."""
    import numpy as np

    meta = snap.kv
    if not meta or not eng._prefix_cache:
        return 0
    if eng._spec is not None and \
            getattr(eng._spec.drafter, "stateful", False):
        # a draft-MODEL drafter keeps its own K/V for the same page
        # ids, and the sidecar only carries the target pool: installing
        # would let replay prefix-hit pages whose DRAFT cache is still
        # zeros — outputs stay correct (verify is authoritative) but
        # acceptance would silently collapse after every restore.  Full
        # recompute feeds the drafter through ingest_chunks exactly as
        # the pre-sidecar path did; serializing the draft pool too is
        # the future upgrade.
        return 0
    path = os.path.join(journal_dir, os.path.basename(
        str(meta.get("file", KV_PAGES_NAME))))
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        payload = f.read()
    if zlib.crc32(payload) != int(meta.get("crc", -1)):
        return 0  # torn/stale sidecar: recompute instead
    if str(meta.get("dtype")) != _dtype_name(eng._k_pages.dtype) or \
            int(meta.get("page", -1)) != int(eng._page):
        return 0  # config drift (should be impossible past the
        #         # fingerprint check, but never install wrong bytes)
    import io

    try:
        data = np.load(io.BytesIO(payload))
        k, v = data["k"], data["v"]
    except Exception:
        return 0
    if eng._kv_quant and not ("ks" in data.files and
                              "vs" in data.files):
        # an int8 sidecar without BOTH scale arrays is inconsistent
        # (crc proves the bytes, not the key set): installing would
        # either crash on the missing key or dequantize cached KV
        # with zero scales — fall back to recompute instead
        return 0
    hashes = [bytes.fromhex(h) for h in meta.get("hashes", [])]
    if k.shape[2] != len(hashes) or \
            k.shape[:2] + k.shape[3:] != (eng._num_layers,
                                          eng._num_heads, eng._page,
                                          eng._head_dim):
        return 0
    n = min(len(hashes), eng.pool.free_count)
    if n == 0:
        return 0
    # raw pool allocs (not the engine's fresh-marking wrapper): the
    # installed pages carry LIVE scales that the between-steps scale
    # reset must not zero.  Written in place, before any step graph of
    # the rebuilt engine exists; a sharded engine scatters each rank
    # its heads (the layout JAX re-pins at restore)
    ids = [eng.pool.alloc_page() for _ in range(n)]
    arrays = {"k": k[:, :, :n], "v": v[:, :, :n]}
    if eng._kv_quant:
        arrays.update(ks=data["ks"][:, :, :n], vs=data["vs"][:, :, :n])
    eng._kv_put(ids, arrays)
    installed = 0
    for pid, key in zip(ids, hashes[:n]):
        if eng.pool.register_page(pid, key):
            eng.pool.unref_page(pid)  # refcount 0: retained, evictable
            installed += 1
        else:  # duplicate hash (cannot happen from one pool) — drop
            eng.pool.free_pages([pid])
    return installed


def _journal_state(journal_dir: str):
    """Resolve ``journal_dir``'s last consistent state:
    ``(cfg_rec, snap, state, finished, events)`` — the shared front
    half of `restore_from_dir`, `adopt_from_dir` and
    `compact_journal`.  ``state`` maps each in-flight request id to
    its `RequestWire` (snapshot values with the journal tail replayed
    on top), ``finished`` maps retired ids to their finish reason."""
    path = os.path.join(journal_dir, JOURNAL_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no serve journal at {path}")
    events, _ = read_journal(path)
    if not events or events[0].get("t") != "cfg":
        raise ValueError(
            f"{path} has no config record — not a serve journal")
    cfg_rec = events[0]
    snap = load_snapshot(journal_dir)

    state: "OrderedDict[int, RequestWire]" = OrderedDict()
    finished: Dict[int, str] = {}
    start = 1  # past the cfg record
    if snap is not None:
        for w in snap.records:
            state[w.request_id] = w
        # a snapshot can never be AHEAD of the consistent journal
        # prefix unless the journal lost a torn tail — the snapshot is
        # still authoritative for everything it saw
        start = min(max(snap.journal_pos, 1), len(events))
    for ev in events[start:]:
        t = ev.get("t")
        if t == "a":
            state.setdefault(int(ev["id"]), RequestWire(
                request_id=int(ev["id"]), prompt=list(ev["p"]),
                generated=[], max_new=int(ev["mn"]), streamed=0,
                eos=ev.get("eos"), priority=ev.get("pr"),
                deadline_ms=ev.get("dl"), slo_ttft_ms=ev.get("tt"),
                slo_tpot_ms=ev.get("tp"), trace=ev.get("tr")))
        elif t == "e":
            w = state.get(int(ev["id"]))
            if w is not None:
                w.streamed = max(w.streamed, int(ev["n"]))
        elif t == "f":
            state.pop(int(ev["id"]), None)
            finished[int(ev["id"])] = ev.get("r", "")
    return cfg_rec, snap, state, finished, events


def _next_id_floor(cfg_rec, state, finished) -> int:
    """The smallest request id a new life may issue: past every id the
    journal still names AND past the high-water a previous compaction
    recorded (``nid`` — compaction drops finished ids from the
    journal, so without the floor a thrice-restored serve could reuse
    an id a dead life already streamed under)."""
    return max([rid + 1 for rid in (*state, *finished)] +
               [int(cfg_rec.get("nid", 0))], default=0)


def _compact_resolved(journal_dir: str, cfg_rec, snap, state,
                      finished, events) -> dict:
    """Rewrite the journal (and re-anchor the snapshot) down to the
    already-resolved live state.  The compacted journal carries the
    cfg record (plus the ``nid`` id high-water) and, per in-flight
    request, one admission + one watermark — every finished request
    and superseded watermark drops.  Both files replace atomically
    (temp + fsync + `os.replace`): a crash mid-compaction leaves the
    previous consistent pair.  ``snap`` is re-anchored IN PLACE
    (``journal_pos``/``records``) so a caller holding it keeps a view
    consistent with the file.  Returns the size-before/after stats."""
    path = os.path.join(journal_dir, JOURNAL_NAME)
    bytes_before = os.path.getsize(path)
    cfg = dict(cfg_rec)
    cfg["nid"] = _next_id_floor(cfg_rec, state, finished)
    frames = [_frame(cfg)]
    for w in state.values():
        adm = {"t": "a", "id": w.request_id, "p": list(w.prompt),
               "mn": int(w.max_new), "eos": w.eos, "pr": w.priority,
               "dl": w.deadline_ms, "tt": w.slo_ttft_ms,
               "tp": w.slo_tpot_ms}
        if w.trace is not None:
            adm["tr"] = w.trace
        frames.append(_frame(adm))
        if w.streamed:
            frames.append(_frame({"t": "e", "id": w.request_id,
                                  "n": int(w.streamed)}))
    data = b"".join(frames)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if snap is not None:
        # the snapshot's journal_pos anchored into the OLD journal;
        # re-anchor it to the compacted one (records = the post-tail-
        # replay state, strictly newer than what it held) — without
        # this the next restore would mis-align replay
        snap.journal_pos = len(frames)
        snap.records = list(state.values())
        spath = os.path.join(journal_dir, SNAPSHOT_NAME)
        stmp = spath + ".tmp"
        with open(stmp, "wb") as f:
            f.write(_frame(snap.to_obj()))
            f.flush()
            os.fsync(f.fileno())
        os.replace(stmp, spath)
    from .serving import _stats_add

    _stats_add(journal_compactions=1)
    return {"bytes_before": int(bytes_before),
            "bytes_after": len(data),
            "records_before": len(events),
            "records_after": len(frames)}


def compact_journal(journal_dir: str) -> dict:
    """Compact ``journal_dir``'s write-ahead journal to its live
    state (see `_compact_resolved`); standalone entry for tools and
    tests — `restore_from_dir` compacts inline under
    ``FLAGS_journal_compact``."""
    cfg_rec, snap, state, finished, events = _journal_state(journal_dir)
    return _compact_resolved(journal_dir, cfg_rec, snap, state,
                             finished, events)


def restore_from_dir(journal_dir: str, model, scheduler=None,
                     drafter=None, journal: bool = True,
                     compact: Optional[bool] = None, **overrides):
    """Rebuild an engine in a FRESH process from ``journal_dir`` and
    re-admit every request that was in flight when the previous process
    died.  Returns ``(engine, requests)`` — ``requests`` maps each
    journaled request id to its rebuilt `Request` (re-attach
    ``on_token`` hooks there before driving the engine).

    The caller supplies the ``model`` (weights are not journaled); the
    journal's config record supplies every other constructor argument
    and a config fingerprint the rebuilt engine is validated against —
    a different model or config raises instead of silently serving
    garbage.  State resolution: the newest VALID snapshot supplies
    generated-token values and RNG fold counters; journal records after
    its ``journal_pos`` replay admissions / watermarks / finishes on
    top.  A torn tail record or torn snapshot simply falls back to the
    last consistent state — never a crash, and the emitted-token
    watermarks guarantee a previously streamed token is never re-fired
    at a stream (it is recomputed behind the `_emit` gate; greedy
    recompute is bit-identical, which is what the acceptance bench
    pins).

    ``journal=True`` (default) keeps journaling into the same
    directory, so the restored serve survives a SECOND death.
    ``compact`` (default ``FLAGS_journal_compact``) rewrites the
    journal down to its live state BEFORE the rebuilt engine reopens
    it, so a serve that restores repeatedly starts each life from a
    bounded file instead of an ever-growing one.
    ``overrides`` replace individual engine kwargs (tests/benches)."""
    from ..core import flags as _flags
    from .serving import DecodeEngine, Request, _stats_add

    cfg_rec, snap, state, finished, events = _journal_state(journal_dir)
    if compact is None:
        compact = bool(_flags.flag("journal_compact"))
    comp = None
    if journal and compact:
        # BEFORE engine construction: the DurabilityManager the engine
        # builds reopens (and appends to) the compacted file
        comp = _compact_resolved(journal_dir, cfg_rec, snap, state,
                                 finished, events)

    kw = _engine_kwargs(cfg_rec["cfg"])
    kw.update(overrides)
    if scheduler is not None:
        kw["scheduler"] = scheduler
    if drafter is not None:
        kw["drafter"] = drafter
    eng = DecodeEngine(model,
                       journal_dir=(journal_dir if journal else None),
                       **kw)
    fp = cfg_rec.get("fp")
    if fp and eng.config_fingerprint().hex() != fp:
        raise ValueError(
            "journal config fingerprint does not match the rebuilt "
            "engine — wrong model weights or construction config")
    if snap is not None:
        # the step counters continue where the dead engine's stopped,
        # and a sampling engine's generator from the snapshot's state
        eng._step_no = snap.step_no
        eng._prefill_no = snap.prefill_no
        if snap.cost and eng._cost is not None:
            # newer than the cfg record's calibration (written once)
            eng._cost.load_calibration(snap.cost)
        if snap.rng is not None and eng._sampling["sampler"] != "greedy":
            import torch

            eng._generator.set_state(torch.tensor(
                list(bytes.fromhex(snap.rng)), dtype=torch.uint8))
    # install the serialized prefix-cache payloads (FLAGS_snapshot_kv)
    # BEFORE re-admission queues anything: the replay fold's admission
    # probe then maps the installed pages at refcount+1 and recomputes
    # only the uncached tail — same outputs, a fraction of the compute
    installed_pages = _install_kv_sidecar(journal_dir, snap, eng) \
        if snap is not None else 0

    # journaled ids key the watermarks: new requests in this process
    # must never collide with them (nor with ids a previous
    # compaction dropped — the cfg record's ``nid`` high-water)
    Request._next_id = itertools.count(
        max(_next_id_floor(cfg_rec, state, finished),
            next(Request._next_id)))

    t0 = _obs.now_ns()
    reqs: Dict[int, "object"] = {}
    for rid, w in state.items():
        req = w.materialize()
        if w.max_new - len(w.generated) <= 0:
            # fully generated but the finish record was lost with the
            # torn tail: terminal, nothing to recompute or re-emit
            req.state = "done"
            req.finish_reason = "length"
        else:
            req._engine = eng
            req.t_enqueue_ns = _obs.now_ns()
            if req.deadline_ms is not None:
                req._deadline_ns = req.t_enqueue_ns + \
                    int(req.deadline_ms * 1e6)
            req.fault_info = FaultInfo(
                site="restore", step=snap.step_no if snap else 0,
                recovered=True,
                message="restored from the on-disk journal after "
                        "process death")
            eng._queue.append(req)
        reqs[rid] = req
    _stats_add(restores=1)
    _obs.record_span(
        "engine", "restore", t0, _obs.now_ns() - t0,
        tid=eng._engine_id,
        args={"requests": len(reqs), "journal_events": len(events),
              "snapshot": snap is not None,
              "kv_pages_installed": installed_pages,
              **({"compacted_bytes": comp["bytes_after"],
                  "journal_bytes_before": comp["bytes_before"]}
                 if comp else {})})
    if eng._flight is not None:
        eng._flight.event("restore", requests=len(reqs),
                          journal_events=len(events),
                          snapshot=snap is not None)
    return eng, reqs


def adopt_from_dir(journal_dir: str, engine,
                   delivered: Optional[Dict[int, int]] = None,
                   on_token_factory=None,
                   traces: Optional[Dict[int, str]] = None):
    """Fleet failover: replay a DEAD sibling replica's journal into a
    LIVE survivor ``engine`` (contrast `restore_from_dir`, which
    builds a fresh engine around the journal).  Every in-flight
    request materializes through the replay fold and re-admits via
    `DecodeEngine.admit_restored` — fresh ids (the donor's id space
    may collide with the survivor's), validated, and re-journaled
    into the SURVIVOR's journal so a second death loses nothing.

    ``delivered`` maps donor request ids to the number of generated
    tokens the consumer of record actually received.  The journal's
    streamed watermark is written AHEAD of the socket, so a replica
    can die having journaled a token nobody got: tokens past
    ``delivered`` re-deliver — snapshot-known values return
    immediately as ``backfill``, the rest recompute live — while
    everything at or below it stays behind the emit gate and is never
    re-fired.  Omitted ids (or ``delivered=None``) trust the journal
    watermark, the lossless-but-maybe-duplicating default.

    ``on_token_factory(donor_id)`` (optional) returns the ``on_token``
    hook to attach per adopted request.  ``traces`` (optional) maps
    donor ids to fleet trace ids — a fallback for journals written
    before FLAGS_fleet_trace was on; the journal's own ``tr`` record
    wins when present.  Returns ``(requests, meta)`` keyed by DONOR
    ids: ``requests`` the materialized `Request`s (the survivor's
    fresh ids are on them), ``meta`` per-request ``{"request_id",
    "start_index", "backfill", "done"}`` (plus ``"trace"`` when the
    request carries one) — the resume contract the fleet edge serves
    to reconnecting streams."""
    from .serving import _stats_add

    cfg_rec, snap, state, finished, events = _journal_state(journal_dir)
    fp = cfg_rec.get("fp")
    if fp and engine.config_fingerprint().hex() != fp:
        raise ValueError(
            "journal config fingerprint does not match the adopting "
            "engine — fleet replicas must share model weights and "
            "construction config for zero-loss failover")
    delivered = dict(delivered or {})
    t0 = _obs.now_ns()
    reqs: Dict[int, "object"] = {}
    meta: Dict[int, dict] = {}
    for rid, w in state.items():
        d = delivered.get(rid, w.streamed)
        d = max(0, min(int(d), w.streamed))
        # generated values the snapshot preserved past the delivered
        # point need no recompute: hand them straight back
        backfill = [int(t) for t in w.generated[d:]]
        req = w.materialize()
        if req.trace_id is None and traces and rid in traces:
            # router-supplied fallback (observability.fleettrace): a
            # journal written before FLAGS_fleet_trace was flipped has
            # no "tr" record, but the router still knows the stream's
            # trace id — the adoption keeps it either way
            req.trace_id = str(traces[rid])
        # the router's delivered count supersedes the journal
        # watermark: gate exactly what the consumer saw
        req._emit_gate = max(0, d - len(w.generated))
        done = w.max_new - len(w.generated) <= 0
        if done:
            # fully generated before death (finish record lost):
            # terminal — the backfill above is the whole undelivered
            # tail, nothing to recompute
            req.state = "done"
            req.finish_reason = "length"
        else:
            req.fault_info = FaultInfo(
                site="failover", step=snap.step_no if snap else 0,
                recovered=True,
                message="adopted from a dead replica's journal")
            on_token = on_token_factory(rid) if on_token_factory \
                else None
            engine.admit_restored(req, on_token=on_token)
        reqs[rid] = req
        meta[rid] = {"request_id": int(req.request_id),
                     "start_index": int(d), "backfill": backfill,
                     "done": bool(done)}
        if req.trace_id is not None:
            meta[rid]["trace"] = req.trace_id
    _stats_add(adoptions=1)
    _obs.record_span(
        "engine", "adopt", t0, _obs.now_ns() - t0,
        tid=engine._engine_id,
        args={"requests": len(reqs), "journal_events": len(events),
              "donor": journal_dir})
    if engine._flight is not None:
        engine._flight.event("adopt", requests=len(reqs),
                             donor=journal_dir)
    return reqs, meta


# ---------------------------------------------------------------------------
# The hung-step watchdog
# ---------------------------------------------------------------------------
class StepWatchdog:
    """Monitor armed around `DecodeEngine.step` when
    ``FLAGS_step_timeout_ms`` (or the engine's ``step_timeout_ms``
    argument) is positive.

    Classification: a step is HUNG when it outran the budget AND
    compiled nothing — executable compiles are expected warmup stalls,
    detected by the engine's `_JitTracker` signatures (tracker count /
    trace-cache sizes) changing across the step, so a first-step
    compile never false-positives.  A hung step flips
    ``paddle_engine_health`` to "hung" and raises a fatal
    `errors.HungStep`; the supervisors (`serve_with_recovery`, the
    frontend driver) route it through the existing engine-recovery
    path.  `engine_warm` is the gate the frontend uses before arming
    its harder measure — abandoning a worker thread that never
    returns."""

    engine = _EngineRef()

    def __init__(self, engine, timeout_ms: float):
        self.engine = engine
        self.timeout_ms = float(timeout_ms)
        if self.timeout_ms <= 0:
            raise ValueError(
                f"step_timeout_ms must be > 0 to arm the watchdog, "
                f"got {self.timeout_ms}")
        self._sig = None
        self._armed_t = None

    @property
    def timeout_s(self) -> float:
        return self.timeout_ms / 1e3

    def _tracker_sig(self):
        # step graphs built, signatures met (a first call adds its
        # signature before it compiles or captures, so one in flight on
        # another thread is visible) and graphs captured: keyed on the
        # counters, never on wall time
        ts = self.engine._trackers()
        return (len(ts), sum(len(t._seen) for t in ts),
                self.engine.graph_captures())

    def engine_warm(self) -> bool:
        """Every step graph built so far is warm and at least one step
        completed: arming the frontend's abandon timeout earlier would
        classify a capture as a hang (`compiled_since` covers one the
        engine starts later)."""
        ts = self.engine._trackers()
        return self.engine._step_no > 0 and bool(ts) and \
            all(t.warm for t in ts)

    def sig(self):
        """Opaque compile signature for `compiled_since` (the
        frontend takes it before scheduling a step on the worker)."""
        return self._tracker_sig()

    def compiled_since(self, sig) -> bool:
        """Did an executable compile start or land since ``sig`` was
        taken?  A `_JitTracker` is constructed BEFORE its first jit
        invocation, so a compile still in flight on another thread is
        already visible as a new tracker — the frontend uses this at
        abandon-timeout time to tell a warmup stall from a hang."""
        return self._tracker_sig() != sig

    def arm(self):
        """Called by the engine just before its device step."""
        self._sig = self._tracker_sig()
        self._armed_t = time.perf_counter()

    def disarm(self):
        """Called by the engine after the step returned (either
        verdict) — `overdue` must only ever see an armed window."""
        self._armed_t = None

    # readiness flips at HALF the hang budget: /readyz is a cheap,
    # instantly-reversible routing signal, so it goes early — the
    # router stops sending work while the abandon/rebuild machinery
    # (which pays a snapshot restore) still waits for the full budget.
    # Guarantees the flip PRECEDES abandonment instead of racing it.
    OVERDUE_FRACTION = 0.5

    def overdue(self) -> bool:
        """Is a step CURRENTLY blocked suspiciously long?  Readable
        from any thread while the engine thread is stuck inside its
        device dispatch — the ops plane's `/readyz` consults this so a
        soon-to-be-abandoned engine flips NOT-ready while the step is
        still hanging, not after the post-mortem.  Compiles excuse the
        stall exactly like `classify` (a warmup compile is slow, not
        hung)."""
        t0 = self._armed_t
        if t0 is None or time.perf_counter() - t0 <= \
                self.timeout_s * self.OVERDUE_FRACTION:
            return False
        if not self.engine_warm():
            # readiness trusts the overdue verdict only once every
            # built step graph is warm
            return False
        return self._tracker_sig() == self._sig

    def classify(self, dt_s: float) -> bool:
        """True iff the step that just completed was hung: over budget
        with no compile to excuse it."""
        if dt_s <= self.timeout_s:
            return False
        return self._tracker_sig() == self._sig

    def on_hung(self, dt_s: float):
        """Record the verdict and raise the fatal `HungStep` the
        recovery supervision consumes."""
        from .serving import _stats_add

        _stats_add(hung_steps=1)
        set_health(self.engine._engine_id, "hung")
        raise HungStep(
            f"step stalled: {dt_s * 1e3:.1f}ms against a "
            f"step_timeout_ms budget of {self.timeout_ms:.1f}ms with "
            f"no executable compile in flight — classifying the "
            f"engine as hung")
