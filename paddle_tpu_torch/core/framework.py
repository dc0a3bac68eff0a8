"""Process-global framework state: grad mode and the random generators
(counterpart: paddle_tpu/core/framework.py).

Grad mode is torch's own (``torch.is_grad_enabled``): the guards below
enter ``torch.no_grad`` / ``torch.enable_grad``.  The JAX package's trace
mode has no counterpart: the port captures CUDA graphs of eager steps
(`inference.serving._StepGraph`), and no random number may be drawn
inside a capture (`Generator.for_device` raises there).

Randomness: `seed` reseeds the default `Generator`, which owns one
``torch.Generator`` per device, each seeded from that seed at its first
draw.  Every random draw of the port (initializers, dropout) takes the
generator of the device it draws on; the global torch RNG is never
used.  The streams are not ``jax.random``'s: the same seed gives other
numbers than the JAX package, and another on the CPU than on the card.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["no_grad_guard", "enable_grad_guard", "grad_enabled",
           "Generator", "default_generator", "seed", "generator_for",
           "get_rng_state", "set_rng_state"]


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


@contextlib.contextmanager
def no_grad_guard():
    with torch.no_grad():
        yield


@contextlib.contextmanager
def enable_grad_guard():
    with torch.enable_grad():
        yield


def _capturing(device: torch.device) -> bool:
    return (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class Generator:
    """``paddle.seed``'s generator: one ``torch.Generator`` per device,
    made at its first draw and seeded with this generator's seed."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}
        self._lock = threading.Lock()

    def seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._gens.clear()

    def for_device(self, device) -> torch.Generator:
        """The generator of ``device``; raises inside a CUDA-graph capture,
        where a draw would be baked into every replay."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if _capturing(device):
            raise RuntimeError(
                "a random draw (dropout mask, initializer) inside a "
                "CUDA-graph capture: a replay would reuse the captured "
                "draw; run it outside the capture")
        with self._lock:
            gen = self._gens.get(str(device))
            if gen is None:
                gen = torch.Generator(device=device)
                gen.manual_seed(self._seed)
                self._gens[str(device)] = gen
            return gen


default_generator = Generator(np.random.SeedSequence().entropy % (2 ** 31))


def get_rng_state() -> dict:
    """The default generator's seed and the state of each device's
    ``torch.Generator`` made so far (``{"seed": s, "<device>":
    ByteTensor}``): what a checkpoint keeps so a resumed run draws what an
    unbroken run draws."""
    g = default_generator
    with g._lock:
        out = {k: gen.get_state() for k, gen in g._gens.items()}
        out["seed"] = g._seed
    return out


def set_rng_state(state: dict):
    """Restore `get_rng_state`'s result: the seed, and each saved
    device's generator (numpy arrays or tensors); the generators of other
    devices start afresh from the seed."""
    g = default_generator
    g.seed(int(np.asarray(state["seed"])))
    for dev, st in state.items():
        if dev == "seed":
            continue
        st = st if isinstance(st, torch.Tensor) else \
            torch.from_numpy(np.array(st, dtype=np.uint8))
        g.for_device(dev).set_state(st.detach().cpu().to(torch.uint8))


def seed(s: int) -> Generator:
    default_generator.seed(int(s))
    return default_generator


def generator_for(device) -> torch.Generator:
    return default_generator.for_device(device)
