"""Activation recompute (counterpart: paddle_tpu/distributed/fleet/
utils/recompute.py).

``recompute(function, *args)`` runs ``function`` without keeping its
activations for the backward, and replays it during the backward to get
them back: what the JAX package's compiled path does with
``jax.checkpoint`` (its eager path keeps the activations).  It rides on
``torch.utils.checkpoint``'s non-reentrant form, whose saved-tensor hooks
drop the block's activations.  Two states of the port's own, which
torch's checkpoint does not know, are put back for the replay (and
restored after it): the `amp.auto_cast` state of the forward, so the
replay casts as the forward did; and, with ``preserve_rng_state``,
`core.framework`'s per-device generators (the port draws dropout from
them, not from torch's global one), so the replayed masks are the
forward's.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils import checkpoint as _ckpt

from .... import amp as _amp
from ....core import framework as _fw

__all__ = ["recompute"]


class _Snapshot:
    """The forward's amp state (and generator states); the replay's
    context sets them and puts the live ones back after."""

    def __init__(self, rng: bool):
        self.rng = rng
        self.amp = self.state = None

    @contextlib.contextmanager
    def forward(self):
        self.amp = _amp.amp_state()
        if self.rng:
            self.state = _fw.get_rng_state()
        yield

    @contextlib.contextmanager
    def replay(self):
        live_amp = _amp.amp_state()
        live = _fw.get_rng_state() if self.rng else None
        _amp._state.enabled, _amp._state.dtype = self.amp
        if self.rng:
            _fw.set_rng_state(self.state)
        try:
            yield
        finally:
            _amp._state.enabled, _amp._state.dtype = live_amp
            if self.rng:
                _fw.set_rng_state(live)


def recompute(function, *args, **kwargs):
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    snap = _Snapshot(rng=preserve)
    return _ckpt.checkpoint(function, *args, use_reentrant=False,
                            preserve_rng_state=preserve,
                            context_fn=lambda: (snap.forward(),
                                                snap.replay()),
                            **kwargs)
