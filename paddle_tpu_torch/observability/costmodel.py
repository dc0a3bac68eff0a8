"""Serving cost observatory: counted FLOP/byte profiles, calibrated
step-cost prediction, an HBM ledger, and roofline accounting
(counterpart: paddle_tpu/observability/costmodel.py, copied and adapted,
not imported).

* **Static cost profiles** — every serving step passes through the
  `_StepGraph` chokepoint (inference.serving).  The FIRST call of each
  step signature runs the step eagerly anyway (on the card it is the
  warm-up that precedes the capture), and with the observatory armed
  that run goes through `count_executable`: a dispatch-mode tally
  (`_OpTally`) counts each aten op's FLOPs (PyTorch's
  ``flop_counter`` formulas for the matrix products, one per output
  element otherwise) and bytes, so no extra run is ever made.  Kernels
  K1/K2 are ``ctypes`` launches no dispatch mode sees: the
  `ops.paged_attention.paged_attention` entry adds its own work formula
  (`paged_attention_work`) as one row and hides its inner ops from the
  tally, on the card and on the CPU alike.  A profile's
  ``bytes_accessed`` is `analytical_gpt_cost` at the call's shapes (the
  weight and KV streams a serve step moves), its ``source`` is
  ``"counted"`` where the JAX package's reads ``"hlo"``.  Profiles are
  keyed by `profile_signature` and stored in the process-global
  `_PROFILES` table under the module lock.

* **Calibrated step-cost prediction** — `CostModel.predict_step_cost`:
  the raw roofline time of the executables the step will run
  (``max(flops/peak_flops, bytes/peak_bw)``, summed) times a
  per-executable EWMA calibration factor learned from the flight
  recorder's measured step times; the predicted-vs-actual error is
  ``paddle_step_cost_error_ratio{fn}``.

* **HBM ledger** — `CostModel.hbm_ledger` attributes the engine's known
  device tensors by their bytes: weights by storage dtype, ``kv_pages``,
  ``kv_scales`` and ``draft_pool``; ``temp_scratch`` is the engine's
  CUDA-graph pool (the bytes the graph memory measures at each
  capture).  The unattributed residue is measured against
  ``torch.cuda.memory_allocated()`` on the engine thread at each audit
  (``FLAGS_cost_ledger_interval_steps``) and published for any-thread
  readers; on the CPU it reads None ("not measured").

* **Roofline accounting** — per-phase ``paddle_phase_mfu{phase}`` and
  ``paddle_phase_hbm_util{phase}`` against the peaks of `resolve_peaks`
  (``FLAGS_peak_flops`` / ``FLAGS_peak_hbm_gbps`` / ``FLAGS_peak_ici_gbps``,
  else the device table: the H100 at its datasheet dense bf16 rate, HBM
  rate and NVLink 4 rate a direction, and the JAX package's pinned CPU
  values).  A sharded step's profile (``serve_mesh``) carries its
  ``collective_bytes`` (`parallel.partition.collective_bytes`, counted
  from the step's shapes where JAX reads its HLO), published as
  ``paddle_collective_bytes{fn}`` and added to the roofline time over
  the interconnect rate.  On a one-card mesh the ranks' gloo all-reduces
  go through host memory, not NVLink: there the term is a ceiling the
  run never reaches.  A device phase's time is its dispatch
  wall plus the step's ``fetch`` wall: a CUDA graph replay returns
  before the device finishes, and the token fetch is where the host
  waits for it.

Arming: ``FLAGS_cost_model`` (default on) or the engine's
``cost_model=`` argument.  Disarmed, the hot path pays one ``is None``
check per step and no profile is counted.

Threading: counting and every calibration mutation happen on the engine
thread; `DecodeEngine.statusz` (any thread) reads the tables under the
module ``_lock``.  Nothing an any-thread reader calls touches the
device.  The cost model reads engine state and never mutates it.
"""
from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, Optional

from .metrics import _state

__all__ = ["CostProfile", "CostModel", "enabled", "count_executable",
           "profile_signature", "analytical_gpt_cost", "profiles",
           "profile_by_key", "clear_profiles", "resolve_peaks",
           "LEDGER_CATEGORIES", "HOT_OP_TOP_K"]

# THE cost-observatory lock: the process-global profile table and every
# CostModel's calibration/error tables mutate under it
_lock = threading.RLock()

# signature -> CostProfile, shared across engines (a recovery handoff
# pair runs byte-identical steps and shares one profile)
_PROFILES: Dict[tuple, "CostProfile"] = {}

# HBM ledger category vocabulary (the paddle_hbm_ledger_bytes label set)
LEDGER_CATEGORIES = ("weights", "weights_int8", "weight_scales",
                     "kv_pages", "kv_scales", "draft_pool",
                     "temp_scratch", "misc")

# steps between error/roofline gauge refreshes (see CostModel.observe)
_GAUGE_EVERY = 8

# EWMA smoothing for the calibration factor and the error gauge
_EWMA_ALPHA = 0.25

# Pinned CPU roofline "peaks" (the JAX package's values): CPU MFU
# numbers are meaningless as absolutes, but pinned they are
# deterministic run over run.
_CPU_PEAK_FLOPS = 5.0e10   # 50 GFLOP/s
_CPU_PEAK_BYTES = 2.0e10   # 20 GB/s
_CPU_PEAK_ICI = 1.0e10     # 10 GB/s

# device-name substring -> (peak FLOP/s dense bf16, peak HBM bytes/s,
# peak interconnect bytes/s a direction), datasheet numbers (the H100
# SXM: NVLink 4, 900 GB/s bidirectional); the flags override for
# anything unlisted
_DEVICE_PEAKS = (
    ("h100", 989e12, 3.35e12, 450e9),
)

# top-K rows kept per executable's hot-op table
HOT_OP_TOP_K = 8

_forced_engines = 0


def _force_enable():
    """An engine constructed with ``cost_model=True`` while the flag is
    off: counting must serve it too (the profile table is global)."""
    global _forced_engines
    with _lock:
        _forced_engines += 1


def enabled() -> bool:
    """Is profile counting armed?  FLAGS_cost_model, or any engine
    constructed with an explicit ``cost_model=True``."""
    if _forced_engines:
        return True
    from ..core import flags as _flags

    return bool(_flags.flag("cost_model"))


def resolve_peaks(device=None) -> Dict[str, float]:
    """The roofline ceilings: ``FLAGS_peak_flops`` / ``FLAGS_peak_hbm_gbps``
    / ``FLAGS_peak_ici_gbps`` when positive, else by ``device``'s name
    from the table above (a CPU device, or an unlisted card, pins the
    CPU test values).  Reads the card's name once, at engine
    construction."""
    from ..core import flags as _flags

    flops = float(_flags.flag("peak_flops"))
    gbps = float(_flags.flag("peak_hbm_gbps"))
    ici = float(_flags.flag("peak_ici_gbps"))
    kind = ""
    if device is not None and getattr(device, "type", "") == "cuda":
        import torch

        kind = torch.cuda.get_device_name(device).lower()
    det_f, det_b, det_i, source = _CPU_PEAK_FLOPS, _CPU_PEAK_BYTES, \
        _CPU_PEAK_ICI, "cpu-pinned"
    for sub, pf, pb, pi in _DEVICE_PEAKS:
        if sub in kind:
            det_f, det_b, det_i, source = pf, pb, pi, f"autodetect:{kind}"
            break
    if flops > 0 and gbps > 0:
        source = "flags"
    return {"flops": flops if flops > 0 else det_f,
            "bytes_per_s": gbps * 1e9 if gbps > 0 else det_b,
            "ici_bytes_per_s": ici * 1e9 if ici > 0 else det_i,
            "source": source}


@dataclass
class CostProfile:
    """Static cost of ONE step signature: total FLOPs (counted), HBM
    bytes (analytical), the CUDA-graph pool bytes its capture took
    (``temp_bytes``, with ``FLAGS_cost_memory_analysis``), and the
    top-K per-op table of the count (``hot_ops``)."""

    site: str
    flops: float
    bytes_accessed: float
    temp_bytes: float = 0.0
    source: str = "counted"  # "counted" | "analytical"
    hot_ops: tuple = ()
    collective_bytes: float = 0.0  # interconnect volume (no mesh: 0)

    def to_obj(self) -> dict:
        return {"site": self.site, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "temp_bytes": self.temp_bytes, "source": self.source,
                "collective_bytes": self.collective_bytes,
                "hot_ops": [dict(r) for r in self.hot_ops]}


def _leaves(x):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def profile_signature(site: str, args) -> tuple:
    """The profile key, JAX's scheme: the site label and one
    ``(shape, dtype, weak_type)`` row per array operand (a dict operand,
    the params tree, flattens to its leaves' shapes and dtypes; a
    non-array keys by type and value).  Dtypes read as numpy names, so
    a host array and a tensor of one dtype key alike."""
    def dt(a):
        return str(a.dtype).replace("torch.", "")

    sig = []
    for a in args:
        if isinstance(a, dict):
            sig.append(tuple((tuple(x.shape), dt(x)) for x in _leaves(a)
                             if hasattr(x, "shape")))
        elif hasattr(a, "shape") and hasattr(a, "dtype"):
            sig.append((tuple(a.shape), dt(a), False))
        else:
            sig.append(("s", type(a).__name__, repr(a)[:32]))
    return (site, tuple(sig))


# ---------------------------------------------------------------------------
# the op tally (the port's counterpart of HLO cost analysis + the jaxpr
# hot-op walk): one TorchDispatchMode over the step's eager run
# ---------------------------------------------------------------------------
_SHORT_DTYPE = {
    "float32": "f32", "float64": "f64", "float16": "f16",
    "bfloat16": "bf16", "int8": "s8", "int16": "s16", "int32": "s32",
    "int64": "s64", "uint8": "u8", "bool": "pred",
}


def _short(dtype) -> str:
    s = str(dtype).replace("torch.", "")
    return _SHORT_DTYPE.get(s, s)


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _tensor_elems(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_elems(v) for v in x)
    return 0


# aten ops that move or reinterpret data without arithmetic
_FREE_OPS = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "slice", "select", "alias", "as_strided",
    "detach", "empty", "empty_like", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "arange", "lift_fresh", "_to_copy",
    "copy_", "clone", "contiguous", "split", "split_with_sizes", "unbind",
    "lift_fresh_copy", "empty_strided", "new_empty", "new_zeros",
    "scalar_tensor", "_local_scalar_dense"))


def _make_tally():
    """A TorchDispatchMode that aggregates (flops, bytes, count) per op
    key over what it dispatches.  Built on first use: the tests import
    every module, and the mode's base class lives in torch."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _OpTally(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows: Dict[str, list] = {}
            self._paused = 0

        def note(self, key: str, flops: float, nbytes: float):
            row = self.rows.setdefault(key, [0.0, 0.0, 0])
            row[0] += float(flops)
            row[1] += float(nbytes)
            row[2] += 1

        def pause(self):
            tally = self

            class _P:
                def __enter__(self):
                    tally._paused += 1

                def __exit__(self, *exc):
                    tally._paused -= 1
                    return False
            return _P()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if self._paused:
                return out
            packet = func._overloadpacket
            name = packet.__name__
            if name in _FREE_OPS:
                return out
            try:
                if packet in flop_registry:
                    flops = float(flop_registry[packet](
                        *args, **kwargs, out_val=out))
                    ts = [a for a in args if isinstance(a, torch.Tensor)]
                    key = name + "[" + "x".join(
                        _short(t.dtype) for t in ts[-2:]) + "]"
                else:
                    flops = float(_tensor_elems(out))
                    key = name
                nbytes = _tensor_bytes(list(args)) + _tensor_bytes(out)
                self.note(key, flops, nbytes)
            except Exception:  # a formula that cannot read these args
                pass
            return out

        @property
        def flops(self) -> float:
            return sum(r[0] for r in self.rows.values())

        @property
        def bytes(self) -> float:
            return sum(r[1] for r in self.rows.values())

        def table(self, top_k: int = HOT_OP_TOP_K) -> tuple:
            total_f = self.flops or 1.0
            total_b = self.bytes or 1.0
            rows = sorted(self.rows.items(),
                          key=lambda kv: (-kv[1][0], -kv[1][1], kv[0]))
            return tuple(
                {"op": name, "count": int(c), "flops": f, "bytes": b,
                 "flops_frac": round(f / total_f, 6),
                 "bytes_frac": round(b / total_b, 6)}
                for name, (f, b, c) in rows[:int(top_k)])

    if not _WARM:
        # the first entry into a dispatch mode imports a large part of
        # torch lazily, and those imports keep the frames on the stack
        # alive: enter one once on a thread of its own, so the frames of
        # the step being counted (which hold its engine) are not among
        # them
        def warm():
            with _OpTally():
                torch.ones(2) @ torch.ones(2)
        t = threading.Thread(target=warm, name="paddle-cost-warmup")
        t.start()
        t.join()
        _WARM.append(True)
    return _OpTally()


_WARM: list = []


# the tally of the run being counted, read by the paged-attention entry
# (`ops.paged_attention`): its kernels report their work here
_ACTIVE = [None]


def active_tally():
    return _ACTIVE[0]


def count_executable(site: str, sig_args, run, bytes_of=None,
                     collective_of=None):
    """`_StepGraph` chokepoint hook, at the first call of a step
    signature while the observatory is armed: ``run()`` is that call's
    eager step, run once under the op tally.  Stores the profile
    (FLOPs counted, bytes from ``bytes_of()`` when given, collective
    bytes from ``collective_of()`` on a sharded step) under
    `profile_signature` and returns ``(key, run's result)``.  A
    signature already profiled runs uncounted.  Counting never changes
    what ``run`` computes, and a counting failure leaves no profile
    (the analytical formula covers it) without hiding the step's own
    exceptions."""
    key = profile_signature(site, sig_args)
    with _lock:
        have = key in _PROFILES
    if have or _ACTIVE[0] is not None:
        return key, run()
    try:
        tally = _make_tally()
    except Exception:
        return None, run()
    _ACTIVE[0] = tally
    try:
        with tally:
            out = run()
    finally:
        _ACTIVE[0] = None
    try:
        prof = CostProfile(
            site=site, flops=tally.flops,
            bytes_accessed=float(bytes_of()) if bytes_of is not None
            else tally.bytes,
            source="counted", hot_ops=tally.table(),
            collective_bytes=float(collective_of())
            if collective_of is not None else 0.0)
    except Exception:
        return None, out
    with _lock:
        _PROFILES[key] = prof
    if prof.collective_bytes > 0:
        from . import COLLECTIVE_BYTES

        COLLECTIVE_BYTES.set(prof.collective_bytes, fn=site)
    from ..inference.serving import _stats_add

    _stats_add(cost_profiles=1)
    return key, out


def note_temp_bytes(key, nbytes: int):
    """A capture's CUDA-graph pool growth, recorded on its profile when
    ``FLAGS_cost_memory_analysis`` is on (the counterpart of XLA's
    temp-buffer analysis)."""
    from ..core import flags as _flags

    if key is None or not bool(_flags.flag("cost_memory_analysis")):
        return
    with _lock:
        prof = _PROFILES.get(key)
        if prof is not None:
            prof.temp_bytes = float(nbytes)


def profile_by_key(key: tuple) -> Optional[CostProfile]:
    with _lock:
        return _PROFILES.get(key)


def profiles() -> Dict[str, dict]:
    """Snapshot of the process-global profile table, keyed by site."""
    with _lock:
        items = list(_PROFILES.items())
    out: Dict[str, dict] = {}
    for (site, _sig), prof in items:
        out[site] = prof.to_obj()
    return out


def clear_profiles():
    with _lock:
        _PROFILES.clear()


def analytical_gpt_cost(*, batch: int, q: int, kv_len: int,
                        layers: int, hidden: int, vocab: int,
                        kv_heads: Optional[int] = None,
                        num_heads: Optional[int] = None,
                        weight_bytes: int = 4,
                        kv_bytes: int = 4) -> Dict[str, float]:
    """Closed-form GPT step cost — the fallback when the backend's HLO
    cost analysis is unavailable.  ``batch`` rows of ``q`` query tokens
    attending over ``kv_len`` cached positions through ``layers``
    transformer blocks of width ``hidden`` (qkv + out projections +
    4x MLP = 12·H² MACs per token) plus one lm-head row per batch
    element; bytes = the weight stream (read once per step — the
    serving regime is weight/KV-bandwidth-bound, the premise of the
    quantized-KV work) + the KV pages read and written."""
    tokens = batch * q
    h = float(hidden)
    dense_flops = 2.0 * tokens * 12.0 * layers * h * h
    attn_flops = 4.0 * batch * q * kv_len * h * layers
    head_flops = 2.0 * batch * h * vocab
    weight_count = 12.0 * layers * h * h + h * vocab + 2.0 * vocab * h
    kvh = float(kv_heads if kv_heads is not None
                else (num_heads or 1))
    nh = float(num_heads or kvh)
    head_dim = h / max(nh, 1.0)
    kv_read = 2.0 * batch * kv_len * layers * kvh * head_dim * kv_bytes
    kv_write = 2.0 * tokens * layers * kvh * head_dim * kv_bytes
    act_bytes = 4.0 * tokens * h * layers * 4
    return {
        "flops": dense_flops + attn_flops + head_flops,
        "bytes_accessed": weight_count * weight_bytes + kv_read +
        kv_write + act_bytes,
    }


class CostModel:
    """One engine's cost observatory: profile lookup, the calibrated
    step-cost predictor, the HBM ledger, and the roofline gauges.
    Constructed by `DecodeEngine.__init__` when armed; reads the
    engine, never mutates it."""

    @property
    def engine(self):
        return self._engine()

    def __init__(self, engine, calibration: Optional[dict] = None):
        # held weakly: an engine dies by reference counting, with its
        # graphs and pools, while its helpers may outlive it
        self._engine = weakref.ref(engine)
        self.peaks = resolve_peaks(engine.device)
        self._calib: Dict[str, float] = {}
        self._err: Dict[str, float] = {}
        if calibration:
            self.load_calibration(calibration)
        # engine-thread-private per-step prediction
        self._pending: Optional[dict] = None
        # (fn, plan, profile keys) -> raw roofline seconds of a plan
        # whose every step has a counted profile
        self._raw_cache: Dict[tuple, float] = {}
        self._steps_since_ledger = 0
        self._steps_since_gauges = _GAUGE_EVERY - 1
        # the residue of the last audit on the engine thread: None until
        # one ran on the card (never on the CPU)
        self._measured: Optional[tuple] = None
        from ..core import flags as _flags

        self._ledger_interval = int(
            _flags.flag("cost_ledger_interval_steps"))

    # -- calibration wire (durability / recovery) ----------------------------
    def calibration_wire(self) -> Dict[str, float]:
        with _lock:
            return dict(self._calib)

    def load_calibration(self, wire: Dict[str, float]):
        with _lock:
            for k, v in dict(wire).items():
                self._calib[str(k)] = float(v)

    # -- static profiles -----------------------------------------------------
    def _tracker_profile(self, tracker) -> Optional[CostProfile]:
        if tracker is None:
            return None
        key = getattr(tracker, "cost_sig", None)
        if key is None:
            return None
        with _lock:
            return _PROFILES.get(key)

    def _analytical(self, *, batch: int, q: int,
                    kv_len: float) -> CostProfile:
        eng = self.engine
        c = analytical_gpt_cost(
            batch=batch, q=q, kv_len=max(int(kv_len), 1),
            **eng._cost_dims())
        return CostProfile(site="analytical", flops=c["flops"],
                           bytes_accessed=c["bytes_accessed"],
                           source="analytical")

    def _tracker_of(self, kind: str):
        eng = self.engine
        if kind == "decode":
            return eng._decode_fn
        if kind == "mixed":
            return eng._mixed_fn
        if kind == "ragged":
            return eng._ragged_fn
        if kind == "verify" and eng._spec is not None:
            return eng._spec._verify_fn
        if kind == "draft_step" and eng._spec is not None:
            return getattr(eng._spec.drafter, "_step_fn", None)
        return None

    def profile_for(self, kind: str) -> CostProfile:
        """The static profile of the step a ``kind`` runs ("decode" |
        "mixed" | "ragged" | "verify" | "draft_step"): the counted
        profile once its tracker ran, else the analytical GPT formula
        at the step's fixed shapes."""
        eng = self.engine
        prof = self._tracker_profile(self._tracker_of(kind))
        if prof is not None:
            return prof
        q = {"mixed": eng._q_max, "ragged": eng._q_ragged,
             "verify": eng._spec.k + 1 if eng._spec is not None else 1
             }.get(kind, 1)
        kv = float(eng._lens.mean()) if eng._lens.any() \
            else eng._max_seq_len / 2
        return self._analytical(batch=eng._slots, q=q, kv_len=kv)

    def raw_seconds(self, prof: CostProfile) -> float:
        """Roofline time of one step: whichever of the compute and
        bandwidth ceilings binds (plus the interconnect term, zero
        without a mesh)."""
        t = max(prof.flops / self.peaks["flops"],
                prof.bytes_accessed / self.peaks["bytes_per_s"])
        cb = getattr(prof, "collective_bytes", 0.0)
        if cb > 0:
            t += cb / self.peaks["ici_bytes_per_s"]
        return t

    # -- the predictor -------------------------------------------------------
    def _composition(self) -> Dict[str, object]:
        eng = self.engine
        act = eng._active.tolist()
        pos = eng._prefill_pos.tolist()
        prefilling = sum(
            1 for s, r in enumerate(eng._by_slot)
            if act[s] and r is not None and pos[s] < len(r.prompt_ids))
        active = sum(act)
        return {
            "active": active,
            "prefilling": prefilling,
            "decoding": active - prefilling,
            "spec": eng._spec is not None and
            eng._resilience.spec_active(),
            "chunked": bool(eng._chunked),
        }

    def _step_plan(self, comp: Dict[str, object]):
        """(fn label, [(kind, invocations)]) for the step this
        composition dispatches to — mirrors `_step_inner`."""
        eng = self.engine
        ragged = bool(getattr(eng, "_ragged", False))
        if comp.get("spec"):
            plan = [("ragged" if ragged else "verify", 1)]
            if getattr(eng._spec.drafter, "_step_fn", None) is not None:
                plan.append(("draft_step", eng._spec.k))
            if comp.get("prefilling"):
                plan.append(("ragged" if ragged else "mixed", 1))
            return "spec", plan
        if ragged:
            return "ragged", [("ragged", 1)]
        if comp.get("chunked") and comp.get("prefilling"):
            return "mixed", [("mixed", 1)]
        return "decode", [("decode", 1)]

    def _predict_parts(self, composition: Optional[dict] = None):
        comp = composition if composition is not None \
            else self._composition()
        fn, plan = self._step_plan(comp)
        # a plan whose steps all have counted profiles prices the same
        # every step: keep it, keyed by the profiles it priced
        key = (fn, tuple(plan), tuple(
            getattr(self._tracker_of(kind), "cost_sig", None)
            for kind, _ in plan))
        raw = self._raw_cache.get(key)
        if raw is None:
            profs = [(self.profile_for(kind), n) for kind, n in plan]
            raw = sum(self.raw_seconds(p) * n for p, n in profs)
            if all(p.source == "counted" for p, _ in profs):
                self._raw_cache[key] = raw
        with _lock:
            calibrated = fn in self._calib
            factor = self._calib.get(fn, 1.0)
        return fn, raw, factor, calibrated

    def predict_step_cost(self,
                          composition: Optional[dict] = None) -> float:
        """Predicted wall seconds of the engine's next step: the raw
        roofline sum times the learned per-executable factor (1.0 until
        the first measured step of that kind)."""
        _fn, raw, factor, _cal = self._predict_parts(composition)
        return raw * factor

    def _tracker_sig(self):
        """Compile signature over the engine's live trackers (the
        watchdog's scheme): a change across a step means a step
        signature ran for the first time during it (a capture, on the
        card), which must not poison the calibration."""
        ts = self.engine._trackers()
        return (len(ts), sum(len(t._seen) for t in ts))

    def note_step_begin(self, flight) -> None:
        """Stamp this step's prediction onto the flight recorder's open
        record, before the step runs."""
        fn, raw, factor, calibrated = self._predict_parts()
        info = {"fn": fn, "raw_s": raw, "predicted_s": raw * factor,
                "calibrated": calibrated}
        self._pending = {"sig": self._tracker_sig()}
        if flight is not None:
            flight.note_cost(info)

    def calibrate(self, rec: dict) -> Optional[float]:
        """The EWMA update from one sealed record's predicted/actual
        pair (JAX's arithmetic); returns the error EWMA it updated, or
        None.  Pure over the record and this model's tables."""
        cost = rec.get("cost")
        actual = float(rec.get("dur_s", 0.0))
        raw = float(cost.get("raw_s", 0.0))
        fn = str(cost.get("fn", "step"))
        if actual <= 0.0 or raw <= 0.0:
            return None
        predicted = float(cost.get("predicted_s", 0.0))
        err = abs(predicted - actual) / actual
        sample = actual / raw
        calibrated = bool(cost.get("calibrated"))
        with _lock:
            prev = self._calib.get(fn)
            self._calib[fn] = sample if prev is None else \
                prev * math.exp(
                    _EWMA_ALPHA * math.log(max(sample, 1e-12) / prev))
            err_ewma = None
            if calibrated:
                prev_e = self._err.get(fn)
                self._err[fn] = err if prev_e is None else \
                    prev_e + _EWMA_ALPHA * (err - prev_e)
                err_ewma = self._err[fn]
        return err_ewma

    def observe(self, rec: dict) -> None:
        """Score the sealed flight record's prediction against its
        measured wall, update the calibration, and refresh the roofline
        and ledger gauges.  Engine thread only."""
        pending, self._pending = self._pending, None
        cost = rec.get("cost")
        if cost is None or rec.get("kind") != "step":
            return
        if pending is None or pending.get("sig") != self._tracker_sig():
            return  # a step signature ran first here: capture time
        if float(rec.get("dur_s", 0.0)) <= 0.0 or \
                float(cost.get("raw_s", 0.0)) <= 0.0:
            return
        err_ewma = self.calibrate(rec)
        fn = str(cost.get("fn", "step"))
        from ..inference.serving import _stats_add

        _stats_add(cost_updates=1)
        eng = self.engine
        if not _state["enabled"] or eng._abandoned:
            return
        if self._ledger_interval > 0:
            self._steps_since_ledger += 1
            if self._steps_since_ledger >= self._ledger_interval:
                self._steps_since_ledger = 0
                self.audit()
        self._steps_since_gauges += 1
        if self._steps_since_gauges < _GAUGE_EVERY:
            return
        self._steps_since_gauges = 0
        obs = _obs()
        if err_ewma is None:
            with _lock:
                err_ewma = self._err.get(fn)
        if err_ewma is not None:
            obs.STEP_COST_ERROR.set(err_ewma, fn=fn)
        for phase, v in self.roofline(rec).items():
            obs.PHASE_MFU.set(v[0], phase=phase)
            obs.PHASE_HBM_UTIL.set(v[1], phase=phase)

    def roofline(self, rec: dict) -> Dict[str, tuple]:
        """{phase: (mfu, hbm_util)} of one sealed record's device
        phases: profile FLOPs and bytes over the phase's dispatch wall
        plus the record's fetch wall (where the host waited for the
        device), against the peaks.  A ragged engine's phases all ran
        the ragged step."""
        eng = self.engine
        phases = rec.get("phases", {})
        fetch = phases.get("fetch", 0.0)
        ragged = bool(getattr(eng, "_ragged", False))
        out = {}
        for phase in ("decode", "mixed", "verify"):
            dt = phases.get(phase)
            if not dt:
                continue
            prof = self.profile_for("ragged" if ragged else phase)
            t = dt + fetch
            out[phase] = (prof.flops / t / self.peaks["flops"],
                          prof.bytes_accessed / t
                          / self.peaks["bytes_per_s"])
        return out

    # -- the HBM ledger ------------------------------------------------------
    def audit(self):
        """The periodic audit, on the engine thread between steps:
        measure the residue against the allocator (on the card), then
        publish the ledger and headroom gauges."""
        self.hbm_ledger(set_gauges=True, measure=True)
        _obs().CAPACITY_HEADROOM.set(
            self.headroom()["admissible_slots"],
            engine=self.engine._engine_id)

    def _attributed(self) -> Dict[str, int]:
        eng = self.engine
        owner: Dict[int, tuple] = {}

        def claim(t, cat: str):
            if t is not None and hasattr(t, "element_size"):
                owner.setdefault(id(t), (cat, t.numel() * t.element_size()))

        def claim_weights(tree, draft=False):
            if not tree:
                return
            blocks = tree.get("blocks", [])
            items = [(k, v) for k, v in tree.items() if k != "blocks"]
            items += [(k, v) for b in blocks for k, v in b.items()]
            for name, leaf in items:
                if leaf is None:
                    continue
                if str(leaf.dtype) == "torch.int8":
                    claim(leaf, "weights_int8")
                elif name.endswith("_s"):
                    claim(leaf, "weight_scales")
                else:
                    claim(leaf, "weights")

        claim_weights(eng._params)
        claim(eng._k_pages, "kv_pages")
        claim(eng._v_pages, "kv_pages")
        claim(eng._k_scales, "kv_scales")
        claim(eng._v_scales, "kv_scales")
        if eng._spec is not None:
            d = eng._spec.drafter
            claim_weights(getattr(d, "_params", None) or {})
            for name in ("_k_pages", "_v_pages", "_k_scales",
                         "_v_scales"):
                claim(getattr(d, name, None), "draft_pool")
        cats = {c: 0 for c in LEDGER_CATEGORIES}
        for cat, n in owner.values():
            cats[cat] += n
        mem = getattr(eng, "_graph_memory", None)
        cats["temp_scratch"] = int(getattr(mem, "pool_bytes", 0))
        return cats

    def hbm_ledger(self, set_gauges: bool = False,
                   measure: bool = False) -> dict:
        """Device bytes by category.  ``measure=True`` (engine thread,
        on the card) reads ``torch.cuda.memory_allocated`` and publishes
        the residue: allocated bytes the ledger does not claim (another
        engine's tensors, a step graph's static buffers, leaked
        temporaries).  Any other call reports the last published
        residue, so a reader on another thread touches no device API;
        ``temp_scratch`` (the graph pool) sits beside the
        reconciliation, as XLA's scratch does in the JAX package.  On
        the CPU the residue reads None: not measured."""
        eng = self.engine
        cats = self._attributed()
        attributed = sum(n for c, n in cats.items() if c != "temp_scratch")
        if measure and eng.device.type == "cuda":
            import torch

            total = int(torch.cuda.memory_allocated(eng.device))
            self._measured = (total, max(total - attributed, 0))
        total = unattributed = None
        if self._measured is not None:
            total, unattributed = self._measured
        out = {
            "categories": cats,
            "attributed_bytes": attributed,
            "unattributed_bytes": unattributed,
            "total_live_bytes": total,
        }
        if set_gauges and _state["enabled"] and not eng._abandoned:
            obs = _obs()
            eid = eng._engine_id
            for cat, n in cats.items():
                obs.HBM_LEDGER.set(n, engine=eid, category=cat)
            if unattributed is not None:
                obs.HBM_UNATTRIBUTED.set(unattributed, engine=eid)
        return out

    # -- capacity headroom ---------------------------------------------------
    def headroom(self) -> dict:
        """Admissible extra slots right now: min of free slots, pool
        pages at the running requests' mean page need, and the SLO
        ceiling (all or nothing against the tightest slo_tpot_ms)."""
        eng = self.engine
        pool = eng.pool
        free_slots = len(eng._free_slots)
        avail_pages = max(
            pool.free_count + pool.cached_unreferenced_count -
            pool.reserved, 0)
        per_page = eng._kv_byte_occupancy()["bytes_per_token"] * \
            eng._page
        running = [r for r in eng._by_slot if r is not None]
        if running:
            need = max(int(sum(
                eng._pages_for(r.total_kv_tokens())
                for r in running) / len(running)), 1)
        else:
            need = eng._pages_per_seq
        by_pages = avail_pages // need
        predicted = self.predict_step_cost()
        targets = [r.slo_tpot_ms
                   for r in running + eng._snapshot_queue()
                   if r is not None and r.slo_tpot_ms is not None]
        tightest = min(targets) if targets else None
        slo_ok = tightest is None or predicted * 1e3 <= tightest
        admissible = min(free_slots, by_pages) if slo_ok else 0
        return {
            "admissible_slots": int(admissible),
            "free_slots": int(free_slots),
            "slots_by_pool_pages": int(by_pages),
            "free_pool_bytes": int(avail_pages * per_page),
            "predicted_step_s": predicted,
            "tightest_tpot_ms": tightest,
            "slo_ok": bool(slo_ok),
        }

    # -- cost-model admission (FLAGS_sched_cost_admission) -------------------
    def admission_ok(self, req) -> bool:
        """Admit ``req`` only while the predicted step cost stays within
        the tightest per-token SLO among it and the running set; an
        idle engine always admits."""
        eng = self.engine
        if not eng._active.any():
            return True
        targets = [r.slo_tpot_ms for r in eng._by_slot
                   if r is not None and r.slo_tpot_ms is not None]
        if req.slo_tpot_ms is not None:
            targets.append(req.slo_tpot_ms)
        if not targets:
            return True
        comp = self._composition()
        comp["active"] = comp["active"] + 1
        comp["prefilling"] = comp["prefilling"] + 1
        return self.predict_step_cost(comp) * 1e3 <= min(targets)

    # -- introspection -------------------------------------------------------
    def statusz(self) -> dict:
        """The cost section of `DecodeEngine.statusz`: profiles,
        calibration, error, peaks, ledger, headroom.  Read-only,
        thread-safe, and free of device calls."""
        with _lock:
            calib = dict(self._calib)
            err = dict(self._err)
        return {
            "peaks": dict(self.peaks),
            "profiles": profiles(),
            "calibration": calib,
            "error_ratio": err,
            "ledger": self.hbm_ledger(),
            "headroom": self.headroom(),
        }


_obs_mod = None


def _obs():
    global _obs_mod
    if _obs_mod is None:
        from paddle_tpu_torch import observability

        _obs_mod = observability
    return _obs_mod
