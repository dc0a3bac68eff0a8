"""Shared harness of the port's reliability tests (tests/test_torch_
frontend.py, test_torch_resilience.py, test_torch_durability.py,
test_torch_journal_interop.py): one tiny random GPT, its weights handed
to the port through `params_from_numpy`, and a `Side` per package that
builds engines and reaches the package's serving, frontend, resilience,
durability, errors, observability and flags modules under one set of
names.  A scenario written once against a `Side` runs on the JAX engine
and on the port's (``device="cpu"``), and `both` returns the two
results for the test to hold equal.
"""
import asyncio
import contextlib
import functools
import itertools

import numpy as np

import jax

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.core import flags as jflags
from paddle_tpu.inference import durability as JD
from paddle_tpu.inference import errors as JE
from paddle_tpu.inference import frontend as JF
from paddle_tpu.inference import resilience as JR
from paddle_tpu.inference import serving as JS
from paddle_tpu.models.gpt import GPT, GPTConfig
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.inference import durability as TD
from paddle_tpu_torch.inference import errors as TE
from paddle_tpu_torch.inference import frontend as TF
from paddle_tpu_torch.inference import resilience as TR
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.inference.weights import params_from_numpy
from paddle_tpu_torch.models.gpt import GPT as TGPT
from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig

# the TINY config of the JAX reliability tests
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=256, use_parallel_layers=False, dropout=0.0)


@functools.lru_cache(maxsize=None)
def models(seed=0):
    """A random JAX GPT (``paddle.seed(seed)``) and the port's GPT over
    the same weights."""
    paddle.seed(seed)
    m = GPT(GPTConfig(**TINY))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, JS._extract_gpt_params(m))
    tm = TGPT.from_params(TGPTConfig(**TINY),
                          params_from_numpy(tree, device="cpu"))
    return m, tm


class Side:
    """One package's serving stack over the shared weights."""

    def __init__(self, name, seed=0, **defaults):
        self.name = name
        self.jax = name == "jax"
        if self.jax:
            self.S, self.F, self.R, self.D, self.E = JS, JF, JR, JD, JE
            self.obs, self._flags = jobs, jflags
        else:
            self.S, self.F, self.R, self.D, self.E = TS, TF, TR, TD, TE
            self.obs, self._flags = tobs, tflags
        self.model = models(seed)[0 if self.jax else 1]
        self.defaults = defaults

    def engine(self, model=None, **kw):
        kw = {**self.defaults, **kw}
        if not self.jax:
            kw["device"] = "cpu"
        return self.S.DecodeEngine(model or self.model, **kw)

    def reset(self, first_id=1000):
        """Zero the telemetry, and restart request ids at ``first_id``
        so both packages' journals carry the same ids."""
        self.S.reset_decode_stats()
        self.obs.reset()
        self.obs.clear_spans()
        self.S.Request._next_id = itertools.count(first_id)

    def stats(self):
        return self.S.decode_stats()

    @contextlib.contextmanager
    def flags(self, **kw):
        old = {k: self._flags.flag(k) for k in kw}
        self._flags.set_flags(kw)
        try:
            yield
        finally:
            self._flags.set_flags(old)


def both(fn, seed=0, **defaults):
    """``(fn(jax side), fn(port side))``, telemetry reset before each."""
    out = []
    for name in ("jax", "torch"):
        side = Side(name, seed, **defaults)
        side.reset()
        out.append(fn(side))
    return tuple(out)


def port(seed=0, **defaults):
    side = Side("torch", seed, **defaults)
    side.reset()
    return side


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def prompt(rng, n=8):
    return rng.randint(0, TINY["vocab_size"], (n,)).astype(np.int32)


def fault_dict(info):
    """A `FaultInfo` as a comparable dict (None stays None)."""
    return None if info is None else info.as_dict()
