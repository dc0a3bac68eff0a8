"""`paddle.static` equivalent (counterpart: paddle_tpu/static/__init__.py).

Reference: `python/paddle/static/` re-exports the Program/Executor static
graph stack (`fluid/framework.py`, `fluid/executor.py:916`,
`fluid/backward.py:1369`).

Here a "static program" is a real ProgramDesc (`program.Program`) run by
the torch interpreter (`interp.ProgramRunner`): `Executor.run` over
forward programs and plain callables, `program_guard` and the default
programs, `save_inference_model`/`load_inference_model` in the reference
interchange format (framework.proto ProgramDesc + combined LoDTensor
records, the legacy ``dir/__model__`` layout too).  Static training
(`append_backward`, `gradients`, `Executor.train_from_dataset`) is the
next slice, 4b: those names exist and raise `NotImplementedError`.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np

from ..core.place import CPUPlace, CUDAPlace, TPUPlace  # noqa: F401
from . import nn  # noqa: E402  (control-flow surface)
from . import proto  # noqa: E402
from .input_spec import InputSpec
from .program import Block, Operator, Program, Variable, \
    program_from_layer  # noqa: E402

__all__ = ["InputSpec", "Program", "Block", "Variable", "Operator",
           "program_from_layer", "Executor", "program_guard",
           "default_main_program", "default_startup_program",
           "save_inference_model", "load_inference_model", "data",
           "device_guard", "cpu_places", "cuda_places", "xpu_places",
           "append_backward", "gradients", "WeightNormParamAttr", "nn",
           "proto"]

_STATIC_TRAINING = ("static training (append_backward, gradients, "
                    "run_grad_op, Executor.train_from_dataset) is not "
                    "ported yet; it lands with slice 4b (ROADMAP.md Queue "
                    "1, item 4b)")


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    raise NotImplementedError(_STATIC_TRAINING)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    raise NotImplementedError(_STATIC_TRAINING)


_default_main = Program()
_default_startup = Program()


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main, _default_startup
    prev = (_default_main, _default_startup)
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = prev


def _device_of(place):
    from ..core.place import to_device

    return None if place is None else to_device(place)


class Executor:
    """Executor over real ProgramDescs (reference `fluid/executor.py:916`
    / `framework/executor.cc:292`): runs the block's ops through the
    torch interpreter, one CUDA graph a feed signature on the card
    (`ProgramRunner`).  Also accepts a bare python callable.  ``place``
    picks the device (default: the card; ``CPUPlace()`` for the CPU)."""

    def __init__(self, place=None):
        self.place = place
        self.scope = {}
        self._runners = {}  # program key -> ProgramRunner

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            **kwargs):
        feed = feed or {}
        if isinstance(program, Program):
            from .interp import ProgramRunner

            # layer-capture params are the DEFAULTS; the live scope
            # (which receives persistable write-back after each run)
            # overrides them
            base = dict(getattr(program, "_param_scope", None) or {})
            base.update(scope if scope is not None else self.scope)
            # key: the op count across all blocks and the desc version,
            # so program mutations invalidate the runner
            key = (id(program),
                   sum(len(blk["ops"]) for blk in program.desc["blocks"]),
                   program.desc.get("version", {}).get("version", 0))
            runner = self._runners.get(key)
            if runner is None:
                runner = ProgramRunner(program, base,
                                       device=_device_of(self.place))
                self._runners[key] = runner
            persist = [v.name for v in program.persistable_vars()]
            fetch_names = [getattr(f, "name", f) for f in fetch_list or ()]
            # the run hands out only these, each the caller's (a captured
            # graph's outputs are copied: the next replay rewrites them)
            fetch_vals, final_scope = runner.run_with_scope(
                feed, params=base, names=persist + fetch_names)
            # persistable state written by the program flows back into
            # the scope (reference executor semantics)
            for name in persist:
                if name in final_scope:
                    target = scope if scope is not None else self.scope
                    target[name] = final_scope[name]
            if fetch_list:
                out = []
                for name in fetch_names:
                    if name in final_scope:
                        out.append(final_scope[name])
                    else:
                        known = sorted(v.name for v in program.list_vars())
                        raise KeyError(
                            f"fetch target {name!r} was not produced by "
                            f"the program (known vars: {known[:20]}...)")
                return out
            return list(fetch_vals)
        if callable(program):
            outs = program(**feed)
            return outs if isinstance(outs, (list, tuple)) else [outs]
        return []

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Dataset-driven static training (reference
        `fluid/executor.py:1663`): slice 4b."""
        raise NotImplementedError(_STATIC_TRAINING)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """reference `fluid/executor.py:1540`: the same loop as
        `train_from_dataset` (slice 4b)."""
        raise NotImplementedError(_STATIC_TRAINING)


def _np(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _combined_params_bytes(program: Program, scope: dict) -> bytes:
    """Reference `.pdiparams` / `__params__`: concatenated LoDTensor
    streams in LEXICOGRAPHIC var-name order (`inference/io.cc:112`).
    Every persistable var must be in `scope` — a silent skip would shift
    every later record onto the wrong name at load time."""
    names = sorted(v.name for v in program.persistable_vars())
    missing = [n for n in names if n not in scope]
    if missing:
        raise ValueError(
            f"save_inference_model: persistable vars missing from scope: "
            f"{missing}")
    return b"".join(proto.write_lod_tensor(_np(scope[n])) for n in names)


def _load_combined_params(program: Program, data: bytes) -> dict:
    names = sorted(v.name for v in program.persistable_vars())
    scope = {}
    pos = 0
    for n in names:
        if pos >= len(data):
            raise ValueError(
                f"params file truncated: no record for var {n!r} "
                f"(expected {len(names)} records)")
        arr, _lod, pos = proto.read_lod_tensor(data, pos)
        want = program.global_block().var(n).shape if \
            program.global_block().has_var(n) else ()
        if want and len(want) == arr.ndim and any(
                w != -1 and w != s for w, s in zip(want, arr.shape)):
            raise ValueError(
                f"param {n!r} shape {arr.shape} does not match its "
                f"VarDesc {tuple(want)} — records/vars out of sync")
        scope[n] = arr
    if pos != len(data):
        raise ValueError(
            f"params file has {len(data) - pos} trailing bytes after "
            f"{len(names)} records — program/params mismatch")
    return scope


def save_inference_model(path_prefix, feed_vars=None, fetch_vars=None,
                         executor=None, program=None, layer=None,
                         input_spec=None, scope=None, **kwargs):
    """Write `{prefix}.pdmodel` + `{prefix}.pdiparams` in the REFERENCE
    interchange format, loadable by reference-era tooling, by the JAX
    package and by the port's Predictor.

    Accepts a desc-backed `program` (+ `scope` of param arrays) or a
    `layer` (+ `input_spec`) converted by `program_from_layer`
    (sequential layers op by op; anything else traced by
    `fx_export`)."""
    if program is None:
        if layer is None:
            raise ValueError(
                "save_inference_model needs program= (desc Program) or "
                "layer= (+input_spec) to convert")
        scope = {}
        program = program_from_layer(layer, input_spec, scope)
    if scope is None:
        scope = {}
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        f.write(program.serialize_to_string())
    with open(path_prefix + ".pdiparams", "wb") as f:
        f.write(_combined_params_bytes(program, scope))
    return program


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Load a reference-format inference model.  Returns
    (program, feed_target_names, fetch_target_names); run it with
    `Executor.run(program, feed={...}, fetch_list=[...])` — params are
    pre-populated into the executor scope (or ``program._param_scope``).

    Accepts `{prefix}.pdmodel`/`.pdiparams` pairs and legacy
    `dir/__model__` + `dir/__params__` layouts (`inference/io.cc`).  A
    `.pdmodel` that is a `jit.save` archive loads through `jit.load`."""
    from ..jit import sniff_pdmodel

    if os.path.isdir(path_prefix):
        model_path = os.path.join(path_prefix, "__model__")
        params_path = os.path.join(path_prefix, "__params__")
    else:
        model_path = path_prefix + ".pdmodel"
        params_path = path_prefix + ".pdiparams"
    with open(model_path, "rb") as f:
        raw = f.read()
    if sniff_pdmodel(raw) != "program":
        # same extension, another artifact: jit.save's archive (a JAX
        # StableHLO blob raises there, naming the format)
        from .. import jit

        return jit.load(path_prefix)
    program = Program.parse_from_string(raw)
    scope = {}
    if os.path.exists(params_path):
        with open(params_path, "rb") as f:
            scope = _load_combined_params(program, f.read())
    if isinstance(executor, Executor):
        executor.scope.update(scope)
    else:
        program._param_scope = scope
    return program, program.feed_target_names(), \
        program.fetch_target_names()


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


@contextlib.contextmanager
def device_guard(device=None):
    yield


def cpu_places(device_count=None):
    return [CPUPlace(0)]


def cuda_places(device_ids=None):
    """A `CUDAPlace` for each card (``torch.cuda.device_count()``), or
    for ``device_ids``."""
    import torch

    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


xpu_places = cuda_places


class WeightNormParamAttr:
    def __init__(self, *args, **kwargs):
        pass
