"""Flag registry (counterpart: paddle_tpu/core/flags.py).

The names and defaults are paddle_tpu's.  Fifty-two flags work here.
Two more keep their default only, because the code they switch on is
not ported yet (or, for ``compile_cache_dir``, has no counterpart) —
setting one of those to anything else raises NotImplementedError naming
the slice or the reason.  Three keep their default because eager torch
has nothing for them to switch (`_FIXED`): any other value raises
ValueError with the reason.  As in paddle_tpu,
a flag's value is checked where it is read: `DecodeEngine` raises
ValueError on a ``kv_quant`` or ``serve_weights`` mode other than "off"
and "int8".  Setting ``check_nan_inf``, ``benchmark`` or
``eager_dispatch_report`` installs or removes `core.dispatch`'s mode, ``deterministic`` calls
``torch.use_deterministic_algorithms``, ``log_level`` sets the level of
the ``paddle_tpu_torch`` logger.
"""
from __future__ import annotations

import logging
from typing import Any, Dict

__all__ = ["flag", "set_flags", "get_flags"]

# flags whose behaviour the port implements
_PORTED = {
    "chunked_prefill": True,
    "prefill_chunk_tokens": 64,
    "prefix_cache": True,
    "cache_generated_pages": False,
    # "int8": int8 KV pages with per-page, per-head scales (kernel K2)
    "kv_quant": "off",
    # "int8": per-out-channel int8 matmul weights in the serve steps
    "serve_weights": "off",
    # True: LayerNorm's forward runs kernel K5 on CUDA tensors
    "use_pallas_layernorm": False,
    # True: decode, prompt chunks and verify windows share one step
    "ragged_step": False,
    # speculative decoding: K drafted tokens a round (0 = off), the
    # drafter built by name, and adaptive per-slot depth
    "spec_decode_k": 0,
    "spec_drafter": "prompt_lookup",
    "spec_adaptive_k": False,
    "spec_k_min": 1,
    "spec_k_shrink_streak": 2,
    "spec_k_grow_streak": 2,
    # admission scheduler: "fifo" (arrival order) or "slo"
    # (inference.frontend.SLOScheduler)
    "sched_policy": "fifo",
    # the containment ladder (inference.resilience): a fault-injection
    # plan, same-step retries and their backoff, failures before a
    # subsystem degrades, clean steps before the re-enable probe, and
    # engine rebuilds a supervisor may spend
    "fault_inject": "",
    "step_retries": 2,
    "step_backoff_ms": 0.0,
    "degrade_after": 3,
    "degraded_probe_steps": 16,
    "engine_recoveries": 2,
    # durable serving (inference.durability): the write-ahead journal's
    # directory and fsync policy (always | step | never), the snapshot
    # cadence, journal compaction at restore, the KV sidecar, and the
    # hung-step watchdog's budget (0 = off)
    "journal_dir": "",
    "journal_fsync": "step",
    "snapshot_interval_steps": 32,
    "journal_compact": True,
    "snapshot_kv": True,
    "step_timeout_ms": 0.0,
    # the telemetry plane (observability): the flight recorder's ring
    # and dump directory, the cost observatory (profiles, calibrated
    # prediction, HBM ledger, roofline) and its admission gate, the
    # roofline peaks (0 = autodetect), the ledger audit cadence, the
    # ops server (0 = off, -1 = alerts without the listener) and the
    # alert cadence, the profiling plane's probes and capture traces,
    # and the periodic metrics reporter (0 = off)
    "flight_window": 64,
    "flight_dir": "",
    "cost_model": True,
    "sched_cost_admission": False,
    "peak_flops": 0.0,
    "peak_hbm_gbps": 0.0,
    "peak_ici_gbps": 0.0,
    # the CUDA-graph pool's bytes, measured at each capture, stand for
    # XLA's temp scratch: the port has no extra compile to arm
    "cost_memory_analysis": False,
    "cost_ledger_interval_steps": 128,
    "ops_port": 0,
    "alert_interval_steps": 32,
    "profile": False,
    "profile_sample_steps": 64,
    "profile_dir": "",
    "metrics_report_interval_s": 0.0,
    # "mp=N": tensor-parallel serving over N ranks (paddle_tpu_torch.
    # parallel); "" serves unsharded
    "serve_mesh": "",
    # fleet-scope tracing (observability.fleettrace): the fleet router
    # mints a trace id that rides every HTTP leg into the engines
    "fleet_trace": False,
    # debug modes: audit the KV pool at every step boundary; the
    # sanitizer (analysis.sanitizer: warm retraces raise, lock order,
    # host syncs a step, the pool audit)
    "kv_pool_debug": False,
    "sanitize": False,
    # eager checks (core.dispatch): raise FloatingPointError on the first
    # op output holding NaN or Inf; synchronize the device after every op
    "check_nan_inf": False,
    "benchmark": False,
    # the per-op dispatch table (calls, wall time) printed at exit
    "eager_dispatch_report": False,
    # torch.use_deterministic_algorithms
    "deterministic": False,
    # the default dtype of amp.auto_cast
    "amp_dtype": "bfloat16",
    # verbosity of the paddle_tpu_torch logger: 0 warnings, 1 info, 2+ debug
    "log_level": 0,
}

# flag -> (default, why eager torch has nothing for another value to switch)
_FIXED = {
    "eager_jit_ops": (True, "eager torch runs each op directly and has no "
                            "per-op executable cache to turn off"),
    "eager_cache_size": (4096, "eager torch runs each op directly and has "
                               "no per-op executable cache to bound"),
    "use_rbg_rng": (True, "dropout and the initializers draw from "
                          "torch.Generator (core.framework); there is no "
                          "TPU RBG generator to choose"),
}

# flag -> (default, the later slice that ports what it switches on)
_LATER = {
    # "auto": kernels K3/K4 run for every call flash_attention_fwd sends
    # them; the TPU's sequence thresholds and forced modes do not carry over
    "use_pallas_attention": ("auto", "attention kernel policy"),
    # JAX's persistent XLA compile cache: a CUDA graph cannot be
    # serialized, so a fresh process recaptures (no counterpart yet)
    "compile_cache_dir": ("", "persistent step-cache (CUDA graphs cannot "
                              "be serialized)"),
}

_REGISTRY: Dict[str, Any] = dict(_PORTED)
_REGISTRY.update({k: d for k, (d, _) in _LATER.items()})
_REGISTRY.update({k: d for k, (d, _) in _FIXED.items()})


def _key(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: Dict[str, Any]) -> None:
    items = [(_key(k), v) for k, v in flags.items()]
    # validate every key before mutating, as paddle_tpu does
    for k, v in items:
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}")
        if k in _LATER and v != _LATER[k][0]:
            raise NotImplementedError(
                f"{k}={v!r} is not ported yet: it lands with the "
                f"{_LATER[k][1]} slice of paddle_tpu_torch")
        if k in _FIXED and v != _FIXED[k][0]:
            raise ValueError(f"{k} keeps its default {_FIXED[k][0]!r} in "
                             f"paddle_tpu_torch: {_FIXED[k][1]}")
    for k, v in items:
        _REGISTRY[k] = v
    keys = {k for k, _ in items}
    if keys & {"check_nan_inf", "benchmark", "eager_dispatch_report"}:
        from . import dispatch
        dispatch.sync_mode()
    if "deterministic" in keys:
        import torch
        torch.use_deterministic_algorithms(bool(_REGISTRY["deterministic"]))
    if "log_level" in keys:
        level = int(_REGISTRY["log_level"])
        logging.getLogger("paddle_tpu_torch").setLevel(
            logging.WARNING if level <= 0 else
            logging.INFO if level == 1 else logging.DEBUG)


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {k: _REGISTRY[_key(k)] for k in names}


def flag(name: str):
    return _REGISTRY[_key(name)]
