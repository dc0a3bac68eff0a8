"""Auto-checkpoint: preemption-safe epoch-range training (counterpart:
paddle_tpu/incubate/checkpoint/auto_checkpoint.py).

``for epoch in train_epoch_range(n): ...`` yields epoch numbers and,
with auto-checkpointing on, saves the registered models' and optimizers'
state after each epoch (at most every ``save_checkpoint_inter``
seconds, and always after the last); a restarted job with the same job
id skips the epochs done and resumes from the saved state.  Off, it is
``range(n)``.

The JAX package's files and environment, through the port's
``paddle.save``/``load`` (the same pickle format): ``<dir>/<job>/
state.pdparams`` holds ``model_<i>`` and ``opt_<i>`` state dicts, and
``meta.json`` ``{"epoch_no", "timestamp"}``; the state is written first
and the meta last, each through a temporary file and a rename, so a kill
mid-save leaves the previous pair.  The port adds ``rng`` to the state:
the default generator's seed and per-device generator states
(`core.framework.get_rng_state`), so dropout after a resume draws what
an unbroken run draws.  A job directory the JAX package wrote resumes
here (its models and optimizers; it has no ``rng``, so the generators
keep their state).

Environment:
  PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT  on
  PADDLE_JOB_ID                                  the job's name
  PADDLE_EDL_CHECKPOINT_DIR                      the storage directory
  PADDLE_EDL_SAVE_CHECKPOINT_INTER               least seconds between saves
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from ...core import framework as _fw
from ...framework import io as _io

__all__ = ["train_epoch_range", "register", "unregister", "_reset"]

_registered = {"models": [], "optimizers": []}


def _enabled() -> bool:
    return os.environ.get("PADDLE_RUNNING_ENV") == \
        "PADDLE_EDL_AUTO_CHECKPOINT"


def _job_dir(checkpoint_dir: Optional[str]) -> str:
    base = checkpoint_dir or os.environ.get("PADDLE_EDL_CHECKPOINT_DIR",
                                            "./auto_checkpoint")
    job = os.environ.get("PADDLE_JOB_ID", "default_job")
    return os.path.join(base, job)


def register(model=None, optimizer=None):
    """Attach a model and/or optimizer whose state travels with the
    checkpoint."""
    if model is not None:
        _registered["models"].append(model)
    if optimizer is not None:
        _registered["optimizers"].append(optimizer)


def unregister():
    _registered["models"].clear()
    _registered["optimizers"].clear()


def _reset():
    unregister()


def _save(job_dir: str, epoch: int):
    os.makedirs(job_dir, exist_ok=True)
    payload = {f"model_{i}": m.state_dict()
               for i, m in enumerate(_registered["models"])}
    payload.update({f"opt_{i}": o.state_dict()
                    for i, o in enumerate(_registered["optimizers"])})
    payload["rng"] = _fw.get_rng_state()
    state_path = os.path.join(job_dir, "state.pdparams")
    _io.save(payload, state_path + ".tmp")
    os.replace(state_path + ".tmp", state_path)
    tmp = os.path.join(job_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"epoch_no": epoch, "timestamp": time.time()}, f)
    os.replace(tmp, os.path.join(job_dir, "meta.json"))


def _load_meta(job_dir: str) -> Optional[dict]:
    path = os.path.join(job_dir, "meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _restore(job_dir: str):
    path = os.path.join(job_dir, "state.pdparams")
    if not os.path.exists(path):
        return
    # numpy arrays: each state dict copies them onto its own tensors'
    # devices
    payload = _io.load(path, return_numpy=True)
    for i, m in enumerate(_registered["models"]):
        if f"model_{i}" in payload:
            m.set_state_dict(payload[f"model_{i}"])
    for i, o in enumerate(_registered["optimizers"]):
        if f"opt_{i}" in payload and hasattr(o, "set_state_dict"):
            o.set_state_dict(payload[f"opt_{i}"])
    if "rng" in payload:
        _fw.set_rng_state(payload["rng"])


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter=None,
                      checkpoint_dir: Optional[str] = None):
    """The epochs ``0 .. max_epoch_num - 1`` not yet done, saving after
    each (see the module docstring)."""
    if not _enabled():
        yield from range(max_epoch_num)
        return
    job_dir = _job_dir(checkpoint_dir)
    inter = save_checkpoint_inter
    if inter is None:
        inter = float(os.environ.get("PADDLE_EDL_SAVE_CHECKPOINT_INTER",
                                     "0"))
    meta = _load_meta(job_dir)
    start = 0
    if meta is not None:
        start = int(meta["epoch_no"]) + 1
        _restore(job_dir)
    last_save = 0.0
    for epoch in range(start, max_epoch_num):
        yield epoch
        now = time.monotonic()
        if now - last_save >= inter:
            _save(job_dir, epoch)
            last_save = now
    if start < max_epoch_num:
        _save(job_dir, max_epoch_num - 1)
