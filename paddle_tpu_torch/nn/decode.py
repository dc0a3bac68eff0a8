"""Sequence decoding (counterpart: paddle_tpu/nn/decode.py): token
sampling, `BeamSearchDecoder` and `dynamic_decode`.

Randomness comes from an explicit ``torch.Generator``.  It cannot
reproduce ``jax.random`` streams, so sampled tokens agree with the JAX
package in distribution only; greedy tokens agree exactly.

Beam search runs a fixed horizon of ``max_step_num`` steps with finished
beams masked (stopping early once every beam has finished), as in the
JAX package: a finished beam continues only with ``end_token`` at no
cost, the ``beam_size`` best of ``beam_size * vocab`` continuations are
kept with JAX's ``top_k`` tie rule (the lowest flat index first), and the
cell's states follow their parent beams.  Non-tensor and 0-d state
leaves (a `PreallocCache`'s length) are shared by every beam and are
neither tiled nor reordered.
"""
from __future__ import annotations

import torch

from ..ops.misc import gather_tree
from ..ops.search import topk

__all__ = ["BeamSearchDecoder", "dynamic_decode", "sample_logits"]

_NEG = -1e30  # the masked-logit value paddle_tpu uses


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def sample_logits(logits: torch.Tensor, sampler: str = "greedy",
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0,
                  generator: torch.Generator = None) -> torch.Tensor:
    """Sample one token per row of ``logits`` [B, V] -> [B] int32.

    ``greedy`` is the argmax (first index on ties, as ``jnp.argmax``);
    ``top_k`` and ``top_p`` (nucleus) draw from ``generator``, which
    must live on the logits' device.  Edge cases as in paddle_tpu:
    ``temperature <= 0`` reduces to greedy, ``top_k`` is clamped to the
    vocab, and the nucleus always keeps rank 0."""
    if sampler != "greedy" and float(temperature) <= 0.0:
        sampler = "greedy"
    if sampler == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError(f"sampler {sampler!r} needs a torch.Generator")
    logits = logits / max(float(temperature), 1e-6)
    if sampler == "top_k":
        if int(top_k) < 1:
            raise ValueError(
                f"sampler 'top_k' needs top_k >= 1, got {top_k}")
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, _NEG))
        return _categorical(logits, generator).to(torch.int32)
    if sampler == "top_p":
        order = torch.argsort(-logits, dim=-1, stable=True)
        sorted_l = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_l.float(), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < float(top_p)
        keep[..., 0] = True
        filt = torch.where(keep, sorted_l, torch.full_like(sorted_l, _NEG))
        pick = _categorical(filt, generator)
        return torch.gather(order, -1, pick[..., None])[..., 0].to(
            torch.int32)
    raise ValueError(f"unknown sampler {sampler!r}")


def _map_states(fn, s):
    """``fn`` over the tensors of ``s`` (tuples, namedtuples, lists,
    dicts); anything else as it is."""
    if isinstance(s, torch.Tensor):
        return fn(s)
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*[_map_states(fn, v) for v in s])
    if isinstance(s, (list, tuple)):
        return type(s)(_map_states(fn, v) for v in s)
    if isinstance(s, dict):
        return {k: _map_states(fn, v) for k, v in s.items()}
    return s


def _first_tensor(s):
    if isinstance(s, torch.Tensor):
        return s
    vals = s.values() if isinstance(s, dict) else \
        s if isinstance(s, (list, tuple)) else ()
    for v in vals:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class BeamSearchDecoder:
    """Beam search over a step ``cell(inputs, states) -> (out,
    new_states)``: ``embedding_fn`` maps token ids to the step's inputs,
    ``output_fn`` the cell's output to vocab logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_states, batch_size):
        """States tiled over the beams (each row ``beam_size`` times in
        turn), start tokens, beam 0 live and the others at -1e9, nothing
        finished."""
        w = self.beam_size
        states = _map_states(
            lambda a: a if a.dim() == 0 else a.repeat_interleave(w, 0),
            initial_states)
        dev = _first_tensor(initial_states).device
        tokens = torch.full((batch_size, w), self.start_token,
                            dtype=torch.int64, device=dev)
        log_probs = torch.tensor([[0.0] + [-1e9] * (w - 1)],
                                 device=dev).repeat(batch_size, 1)
        finished = torch.zeros(batch_size, w, dtype=torch.bool, device=dev)
        return tokens, log_probs, finished, states

    def step(self, tokens, log_probs, finished, states, batch_size):
        w = self.beam_size
        inp = tokens.reshape(-1)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        cell_out, new_states = self.cell(inp, states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), -1).reshape(batch_size, w,
                                                              v)
        fin = torch.full((v,), -1e9, device=logp.device)
        fin[self.end_token] = 0.0
        logp = torch.where(finished[..., None], fin, logp)
        total = (log_probs[..., None] + logp).reshape(batch_size, w * v)
        top_p, top_i = topk(total, w)
        parent = top_i // v
        token = top_i % v
        rows = torch.arange(batch_size, device=parent.device)[:, None]

        def reorder(a):
            if a.dim() == 0:
                return a
            a = a.reshape((batch_size, w) + tuple(a.shape[1:]))
            return a[rows, parent].reshape((-1,) + tuple(a.shape[2:]))

        new_states = _map_states(reorder, new_states)
        new_finished = finished.gather(1, parent) | (token == self.end_token)
        return token, top_p, new_finished, new_states, parent


def dynamic_decode(decoder, inits=None, max_step_num=32, batch_size=None,
                   output_time_major=False, **kwargs):
    """Run ``decoder`` for up to ``max_step_num`` steps (ending once every
    beam has finished); returns the backtraced sequences [B, T, W] ([T,
    B, W] with ``output_time_major``) and the final log-probabilities
    [B, W]."""
    unknown = set(kwargs) - {"is_test", "return_length", "impute_finished"}
    if unknown:
        raise TypeError(f"dynamic_decode: unsupported options {unknown}")
    if batch_size is None:
        batch_size = int(_first_tensor(inits).shape[0])
    tokens, log_probs, finished, states = decoder.initialize(inits,
                                                             batch_size)
    step_ids, parents = [], []
    for _ in range(max_step_num):
        tokens, log_probs, finished, states, parent = decoder.step(
            tokens, log_probs, finished, states, batch_size)
        step_ids.append(tokens)
        parents.append(parent)
        if bool(finished.all()):
            break
    seqs = gather_tree(torch.stack(step_ids), torch.stack(parents))
    if not output_time_major:
        seqs = seqs.transpose(0, 1)
    return seqs, log_probs
