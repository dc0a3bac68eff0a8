"""Export modes and the `rnn` marker op (counterpart:
paddle_tpu/static/export_marker.py).

Two explicit export modes, each set only by the exporter that traces
under it; no run path reads them as a fallback:

* ``"program"`` — `fx_export.program_from_traced` traces a model into a
  reference ProgramDesc.  Kernel wrappers take their plain route (the
  composed attention, the plain LayerNorm), so the program holds only
  reference op types, as the JAX package's CPU trace does; and
  `nn.LSTM`/`GRU`/`SimpleRNN` bind the `rnn` marker below instead of
  unrolling their time loop, so the exporter emits ONE reference `rnn`
  op (`operators/rnn_op.cc`), the single fused op the reference's
  dygraph RNN layers serialize to.
* ``"archive"`` — `jit.save` traces a model with `torch.export`.  Kernel
  wrappers bind their `torch.library` custom ops (K3
  ``paddle_tpu_torch::flash_attention_fwd``, K5
  ``paddle_tpu_torch::layer_norm``), whose CUDA implementation launches
  the kernel and whose CPU implementation is the plain version, so the
  saved graph runs the kernels on the card.

The marker op exists only inside the program-mode trace: its real
implementation raises (it is never executed); its fake implementation
gives the output shapes the exporter reads.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List

import torch

_TLS = threading.local()


def export_mode():
    """``"program"``, ``"archive"`` or None."""
    return getattr(_TLS, "mode", None)


def export_tracing() -> bool:
    """True while `fx_export` traces a model into a ProgramDesc."""
    return export_mode() == "program"


@contextlib.contextmanager
def export_trace_context(mode: str = "program"):
    if mode not in ("program", "archive"):
        raise ValueError(f"unknown export mode {mode!r}")
    prev = export_mode()
    _TLS.mode = mode
    try:
        yield
    finally:
        _TLS.mode = prev


@torch.library.custom_op("paddle_tpu_torch::rnn", mutates_args=())
def rnn_marker(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
               weights: List[torch.Tensor], mode: str, hidden_size: int,
               num_layers: int, is_bidirec: bool, time_major: bool,
               dropout: float) -> List[torch.Tensor]:
    raise RuntimeError(
        "paddle_tpu_torch::rnn is an export-tracing marker and is never "
        "executed; eager RNN layers run their time loop instead")


@rnn_marker.register_fake
def _rnn_fake(x, h0, c0, weights, mode, hidden_size, num_layers,
              is_bidirec, time_major, dropout):
    nd = 2 if is_bidirec else 1
    if time_major:
        t, b = x.shape[0], x.shape[1]
        out_shape = (t, b, hidden_size * nd)
    else:
        b, t = x.shape[0], x.shape[1]
        out_shape = (b, t, hidden_size * nd)
    state = (num_layers * nd, b, hidden_size)
    outs = [x.new_empty(out_shape), x.new_empty(state)]
    if mode == "LSTM":
        outs.append(x.new_empty(state))
    return outs
