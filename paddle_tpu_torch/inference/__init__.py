"""Inference engine (counterpart: paddle_tpu/inference/__init__.py).

Reference: `paddle/fluid/inference/` — `AnalysisConfig`
(`inference/api/paddle_analysis_config.h`), `AnalysisPredictor::Run/
ZeroCopyRun` (`inference/api/analysis_predictor.cc:381,889`) over
`NaiveExecutor`.

The predictor loads one of two artifacts, sniffed from the ``.pdmodel``:

- the reference interchange format (``.pdmodel`` + ``.pdiparams``, or a
  directory with ``__model__``/``__params__``): a framework.proto
  ProgramDesc run by `static.interp.ProgramRunner`;
- the port's `jit.save` archive (`torch.export`), run as a
  `jit.TranslatedLayer`.

``switch_ir_optim`` (on by default) is the counterpart of the JAX
package's one XLA executable a feed signature: on the card each feed
signature is one CUDA graph, captured at its first run and replayed
after (`ops.capture.SignatureGraphs`: host feeds reach the graph's
static inputs in one pinned, asynchronous copy), for both formats; off,
the ops run one by one.  Programs a graph cannot hold run op by op with
a warning (`ProgramRunner`).  The zero-copy handle API (`get_input_handle` /
`copy_from_cpu` / `copy_to_cpu`, `set_lod`) is the reference's.  The
predictor runs on the card unless the config says `disable_gpu()`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.capture import SignatureGraphs, fresh

__all__ = ["Config", "Predictor", "Tensor", "create_predictor",
           "PrecisionType", "PlaceType", "serving", "speculative",
           "frontend", "resilience", "errors", "durability"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 2
    XPU = 3


class Config:
    """reference `AnalysisConfig` (`paddle_analysis_config.h`): model paths
    + device + optimization switches.  Switches that configure TensorRT
    or MKLDNN are taken and change nothing, as in the JAX package."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file
        self._device = "gpu"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._ir_optim = True
        self._memory_optim = False  # opt-in, as in the reference
        self._cpu_math_threads = 1

    # -- model path ---------------------------------------------------------
    def set_model(self, prog_file, params_file=None):
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._model_prefix = prog_file

    def model_dir(self):
        return os.path.dirname(self._model_prefix or "")

    def prog_file(self):
        return (self._model_prefix or "") + ".pdmodel"

    def params_file(self):
        return (self._model_prefix or "") + ".pdiparams"

    # -- device -------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "gpu", device_id

    def enable_tpu(self, device_id=0):
        raise ValueError(
            "paddle_tpu_torch runs on CUDA cards and the CPU: there is no "
            "TPU backend (enable_use_gpu / disable_gpu)")

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device == "gpu"

    def _torch_device(self):
        import torch

        if self._device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)

    # -- switches -----------------------------------------------------------
    def switch_ir_optim(self, x=True):
        # off: run the program op by op, no captured graph (reference:
        # skip OptimizeInferenceProgram)
        self._ir_optim = bool(x)

    def enable_memory_optim(self, x=True):
        # the JAX package donates the feed buffers; a captured graph
        # copies the feeds into its static inputs (see ProgramRunner)
        self._memory_optim = bool(x)

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    def enable_tensorrt_engine(self, *args, **kwargs):
        pass

    def enable_mkldnn(self):
        pass

    def switch_use_feed_fetch_ops(self, x=False):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def set_precision(self, p):
        self._precision = p

    def summary(self):
        return (f"Config(model={self._model_prefix!r}, device={self._device}"
                f":{self._device_id}, ir_optim={self._ir_optim})")


class Tensor:
    """Zero-copy input/output handle (reference `ZeroCopyTensor`,
    `inference/api/details/zero_copy_tensor.cc`)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self._name = name
        self._owner = owner
        self._is_input = is_input

    def name(self):
        return self._name

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        self._owner._inputs[self._name] = np.ascontiguousarray(arr)

    def set_lod(self, lod):
        """reference ZeroCopyTensor::SetLoD: the reference's offset-based
        LoD (1 or 2 levels) or a flat per-sequence lengths list; the
        INNERMOST level becomes the padded+lengths sidecar the lod_* ops
        read; the outer level of a 2-level LoD is kept for lod()."""
        if not self._is_input:
            raise RuntimeError("set_lod on an output handle")
        lod = list(lod)
        if lod and isinstance(lod[0], (list, tuple, np.ndarray)):
            if len(lod) > 2:
                raise NotImplementedError(
                    "LoD deeper than 2 levels is not supported by the "
                    f"padded+lengths redesign; got {len(lod)} levels "
                    "(see PARITY.md 'Multi-level LoD')")

            def offsets(level):
                off = np.asarray(level, np.int64)
                if off.size < 2 or off[0] != 0 or \
                        (np.diff(off) < 0).any():
                    raise ValueError(
                        "offset LoD must start at 0 and be "
                        f"non-decreasing (got {off.tolist()})")
                return off

            levels = [offsets(lv) for lv in lod]
            if len(levels) == 2 and \
                    levels[0][-1] != len(levels[1]) - 1:
                raise ValueError(
                    "2-level LoD mismatch: outer level ends at "
                    f"{levels[0][-1]} but the inner level describes "
                    f"{len(levels[1]) - 1} sequences")
            lengths = np.diff(levels[-1])
            self._owner._outer_lods[self._name] = \
                [lv.tolist() for lv in levels[:-1]]
        elif not lod:
            # an empty LoD clears the tensor's sequence structure
            self._owner._lods.pop(self._name, None)
            self._owner._outer_lods.pop(self._name, None)
            return
        else:
            lengths = np.asarray(lod, np.int64)
            self._owner._outer_lods.pop(self._name, None)
        self._owner._lods[self._name] = lengths.astype(np.int32)

    def lod(self):
        """reference ZeroCopyTensor::lod: offset-based levels.  Input
        handles echo what set_lod stored; output handles report the
        lengths sidecar the program produced for that fetch target."""
        if self._is_input:
            lengths = self._owner._lods.get(self._name)
            if lengths is None:
                return []
            outer = self._owner._outer_lods.get(self._name, [])
            off = np.concatenate([[0], np.cumsum(lengths)]).tolist()
            return [list(lv) for lv in outer] + [off]
        lengths = self._owner._output_lods.get(self._name)
        if lengths is None:
            return []
        off = np.concatenate([[0], np.cumsum(np.asarray(lengths))])
        return [[int(v) for v in off]]

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise RuntimeError("copy_to_cpu on an input handle")
        out = self._owner._outputs.get(self._name)
        if out is None:
            raise RuntimeError("run() the predictor before copy_to_cpu")
        return np.asarray(out)

    def shape(self):
        src = self._owner._inputs if self._is_input else self._owner._outputs
        a = src.get(self._name)
        return list(a.shape) if a is not None else None

    def reshape(self, shape):
        pass  # shapes are taken from copy_from_cpu data


class _LayerRunner:
    """A `jit.TranslatedLayer` run eagerly or, with ``jit`` on the card,
    one CUDA graph a signature (`ops.capture.SignatureGraphs`)."""

    def __init__(self, layer, jit):
        self.layer = layer
        self._graphs = SignatureGraphs(self._call, layer.device) \
            if jit and layer.device.type == "cuda" else None

    def graph_count(self) -> int:
        return 0 if self._graphs is None else len(self._graphs)

    def _call(self, feeds):
        out = self.layer(*feeds.values())
        return out if isinstance(out, tuple) else (out,)

    def __call__(self, inputs, take=None):
        """The layer's outputs on host ``inputs``; ``take`` as
        `static.interp.ProgramRunner`'s."""
        feeds = {str(i): a for i, a in enumerate(inputs)}
        if self._graphs is not None:
            return self._graphs(feeds, fresh if take is None else take)
        from ..static.interp import _to_device

        out = self._call({k: _to_device(a, self.layer.device)
                          for k, a in feeds.items()})
        return out if take is None else take(out)


def _to_host(outs):
    """Host numpy copies of a run's device outputs (a run's ``take``:
    made while the run holds its graph, before another run rewrites
    them); None stays None."""
    return [None if o is None else o.detach().cpu().numpy() for o in outs]


def _lods_to_host(outs_lods):
    return _to_host(outs_lods[0]), _to_host(outs_lods[1])


class Predictor:
    """reference `AnalysisPredictor`: load once, run many (see the module
    docstring for the two formats)."""

    def __init__(self, config: Config):
        from .. import jit as pjit

        self._config = config
        self._inputs: Dict[str, np.ndarray] = {}
        self._lods: Dict[str, np.ndarray] = {}
        self._outer_lods: Dict[str, list] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        self._output_lods: Dict[str, np.ndarray] = {}
        self._output_names: List[str] = []
        prefix = config._model_prefix or ""
        device = config._torch_device()
        kind = "program" if os.path.isdir(prefix) and os.path.exists(
            os.path.join(prefix, "__model__")) else None
        if kind is None:
            with open(prefix + ".pdmodel", "rb") as f:
                kind = pjit.sniff_pdmodel(f.read())
        if kind == "program":
            from ..static import load_inference_model
            from ..static.interp import ProgramRunner

            program, _, _ = load_inference_model(prefix)
            self._runner = ProgramRunner(
                program, getattr(program, "_param_scope", {}) or {},
                jit=config._ir_optim, donate_feeds=config._memory_optim,
                device=device)
            self._layer = None
            self._input_names = list(self._runner.feed_names)
            self._output_names = [f"output_{i}" for i in range(len(
                self._runner.fetch_names))]
        else:
            self._runner = None
            self._layer = _LayerRunner(pjit.load(prefix, device=device),
                                       config._ir_optim)
            self._input_names = [f"input_{i}" for i in
                                 range(self._layer.layer.n_inputs())]

    def graph_count(self) -> int:
        """CUDA graphs captured so far (one a feed signature; 0 with
        ``switch_ir_optim(False)``, on the CPU, or for a program a graph
        cannot hold)."""
        return (self._runner or self._layer).graph_count()

    # -- handle API ---------------------------------------------------------
    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        if name not in self._input_names:
            raise KeyError(name)
        return Tensor(name, self, is_input=True)

    def get_output_names(self):
        if not self._output_names:
            raise RuntimeError("run() once to materialize output names")
        return list(self._output_names)

    def get_output_handle(self, name):
        return Tensor(name, self, is_input=False)

    # -- execution ----------------------------------------------------------
    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Zero-copy run (reference `ZeroCopyRun` analysis_predictor.cc:889).
        Either pass `inputs` positionally or pre-fill via input handles.
        Returns the outputs as host numpy arrays."""
        if inputs is None:
            inputs = [self._inputs[n] for n in self._input_names]
        inputs = [np.asarray(i) for i in inputs]
        out_lods = None
        if self._runner is not None:
            if self._lods:
                outs, out_lods = self._runner.run_with_lods(
                    inputs, self._lods, return_lods=True, take=_lods_to_host)
            else:
                outs = self._runner(*inputs, take=_to_host)
        else:
            if self._lods:
                raise NotImplementedError(
                    "set_lod applies to reference-format (ProgramDesc) "
                    "models only; the jit.save archive has no LoD inputs")
            outs = self._layer(inputs, take=_to_host)
        self._output_names = [f"output_{i}" for i in range(len(outs))]
        self._outputs = dict(zip(self._output_names, outs))
        self._output_lods = {}
        if out_lods is not None:
            for n, lv in zip(self._output_names, out_lods):
                if lv is not None:
                    self._output_lods[n] = lv
        return [self._outputs[n] for n in self._output_names]

    def clone(self):
        """reference AnalysisPredictor::Clone: the clone SHARES the
        loaded program, weights and captured graphs (no reload, no
        recapture) but owns its input/output/LoD state, so each thread
        runs through its own clone.  Runs through clones that share a
        graph take turns on it (`ops.capture.SignatureGraphs`' lock):
        each copies its outputs to the host before the next replays."""
        twin = object.__new__(Predictor)
        twin._config = self._config
        twin._runner = self._runner
        twin._layer = self._layer
        twin._input_names = list(self._input_names)
        twin._output_names = list(self._output_names)
        twin._inputs = {}
        twin._lods = {}
        twin._outer_lods = {}
        twin._outputs = {}
        twin._output_lods = {}
        return twin


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def __getattr__(name):
    # PEP 562 lazy submodule: `paddle_tpu_torch.inference.serving`
    # resolves on first attribute access without loading the serving
    # engine into every import of this package (importlib: a
    # `from . import serving` here would re-enter this __getattr__)
    if name in ("serving", "speculative", "frontend"):
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
