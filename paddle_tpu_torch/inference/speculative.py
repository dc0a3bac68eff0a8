"""Speculative decoding: draft K tokens, verify them in one multi-query
pass (counterpart: paddle_tpu/inference/speculative.py).

A **drafter** proposes K tokens a slot each round, and one **verify
step** scores the last sampled token and the K drafts (K+1 positions) in
one pass through ragged multi-query paged attention (kernel K1, or K2
over int8 pages), drawing a target token at every position with the
engine's own `sample_logits`.  Drafts are accepted while they equal the
targets; the first mismatching target follows as the correction, or the
last target as a bonus when every draft survives.  Every emitted token
is a target draw, so greedy output equals the non-speculative engine's
and sampled output follows the target distribution.

Every step runs through a `serving._StepGraph`, as JAX runs each
through a `_JitTracker`: the verify step (``verify_compiles``; the
engine's ragged step with ``ragged_step``) and the draft model's chunk
ingest, catch-up, single-token step and one-shot prefill
(``draft_compiles``).  Adaptive K changes only the write caps, never a
shape, so a warm speculative serve never meets a new signature.

Rejection costs no page work: the verify window's rows go into pages the
request already holds (`DecodeEngine._grow_block_tables(writes=...)`,
the window clamped to the request's token budget), and a rejected tail
is rolled back by not advancing the host's ``seq_lens`` over it.  Where
the JAX package donates the pools to the verify step, the port writes
them in place; the stale rows past ``seq_lens`` are overwritten later.

Drafters:

* `PromptLookupDrafter` — model-free n-gram lookup over each request's
  own tokens (prompt and generated);
* `DraftModelDrafter` — a small GPT (`GPTConfig.draft_config`), or any GPT
  with the target's vocabulary, over its own page pools indexed by the
  engine's block tables and page ids.

A drafter that raises costs its round, not the step: the verify runs
over zero drafts (one target token a slot, a decode step through the
verify's shapes), and repeated drafter faults degrade speculation off
(`inference.resilience`).  The ``verify`` fault site guards the verify
step and ``nan_logits`` corrupts its targets, as in JAX.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import flags as _flags
from .serving import (_EngineRef, _gpt_decode_step, _gpt_mixed_step,
                      _gpt_prefill, _gpt_ragged_step, _pool_shape,
                      _quantize_gpt_params, _scale_reset_graph, _StepGraph,
                      _tree_to)

__all__ = ["Drafter", "PromptLookupDrafter", "DraftModelDrafter",
           "SpeculativeDecoder", "make_drafter"]

# The verify step: the K+1 window of each slot is a row span of the ragged
# step (tokens [B, K+1] on the split path, padded to the grid's Q_r on the
# ragged path), which writes the rows below each cap and draws a target at
# every position (`_gpt_spec_verify` and `_gpt_spec_verify_q` of the JAX
# package, one function over either kind of page here)
_gpt_spec_verify = _gpt_ragged_step


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------
class Drafter:
    """Proposes K draft tokens a slot each speculative round.

    Lifecycle: ``bind(engine, k)`` once when the engine is built, then
    ``on_admit``/``on_finish`` a request and ``propose``/``on_accept`` a
    round."""

    name = "base"
    # a stateful drafter keeps per-slot state beside the engine's (a draft
    # model's K/V): once degraded away, speculation stays off, since that
    # state went stale while it was off
    stateful = False
    engine = _EngineRef()

    def bind(self, engine, k: int):
        if Drafter.engine.bound(self) and self.engine is not engine:
            raise ValueError(
                "drafter is already bound to another engine: construct "
                "one drafter per DecodeEngine")
        self.engine = engine
        self.k = int(k)

    def on_admit(self, slot: int, req):
        pass

    def on_finish(self, slot: int, req):
        pass

    def ingest_chunks(self, tokens, caps):
        """The engine just fed these prompt chunks to the target model:
        ``tokens`` is the step's [slots, width] batch, ``caps[s]`` the
        chunk length slot ``s`` consumed (0: none this step).  A drafter
        with its own K/V ingests them here."""

    def propose(self, write_caps) -> np.ndarray:
        """[slots, K] int32 draft tokens (inactive rows ignored).
        ``write_caps[s]`` is slot ``s``'s verify window this round, so at
        most ``write_caps[s] - 1`` of its drafts can be accepted; 0 means
        the slot sits the round out (still prefilling) and its row must
        not be advanced."""
        raise NotImplementedError

    def on_accept(self, slot: int, pos_before: int, n_emitted: int):
        """After the verify: ``n_emitted`` tokens were appended and the
        slot's KV length moved to ``pos_before + n_emitted``."""


class PromptLookupDrafter(Drafter):
    """Propose the continuation of the most recent earlier occurrence of
    the sequence's n-gram suffix, longest n first; without one, repeat
    the last token."""

    name = "prompt_lookup"

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]")
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)

    def _lookup(self, hist: np.ndarray) -> np.ndarray:
        k = self.k
        ln = len(hist)
        for n in range(min(self.ngram_max, ln - 1), self.ngram_min - 1, -1):
            suffix = hist[ln - n:]
            # windows that start strictly before the suffix: each has a
            # continuation
            wins = np.lib.stride_tricks.sliding_window_view(hist, n)[:ln - n]
            hits = np.nonzero((wins == suffix).all(axis=1))[0]
            if hits.size:
                s = int(hits[-1])
                cont = hist[s + n:s + n + k]
                if cont.size < k:
                    cont = np.concatenate(
                        [cont, np.full(k - cont.size, hist[-1], hist.dtype)])
                return cont
        return np.full(k, hist[-1], hist.dtype)

    def propose(self, write_caps) -> np.ndarray:
        eng = self.engine
        out = np.zeros((eng._slots, self.k), np.int32)
        for s in range(eng._slots):
            if not eng._active[s] or write_caps[s] == 0:
                continue
            req = eng._by_slot[s]
            out[s] = self._lookup(np.asarray(req.prompt_ids + req.output_ids,
                                             np.int32))
        return out


class DraftModelDrafter(Drafter):
    """A GPT drafter over its own page pools, indexed by the engine's
    block tables and page ids: one allocator governs both caches, so
    admission, growth, rollback and release need nothing of the drafter.

    The draft decodes greedily.  It ingests prompt chunks through
    `_gpt_mixed_step` over its weights (or, on a legacy engine, runs one
    `_gpt_prefill` a request at admission, bucketed as the engine's); a
    round runs one catch-up pass over the tokens accepted since it last
    saw the slot (`_gpt_spec_verify` in the verify's [slots, K+1] frame)
    and K-1 single-token steps (`_gpt_decode_step`).  Each is a
    `_StepGraph` counted under ``draft_compiles``, the catch-up and the
    single-token step made at bind as in JAX.  With int8 pages its pools
    are int8 with their own scales, which the engine zeroes for fresh
    pages as it does its own; with int8 weights its weights fold to int8
    too.  ``steps`` counts its paged step calls, each of which runs every
    draft layer's attention once (the one-shot prefill attends in plain
    PyTorch and is not one of them)."""

    name = "draft_model"
    stateful = True

    def __init__(self, draft_model):
        cfg = draft_model.cfg
        self._params = draft_model.params()
        self._num_heads = cfg.num_heads
        self._head_dim = cfg.hidden_size // cfg.num_heads
        self._eps = float(draft_model.ln_f._epsilon)
        self._vocab = cfg.vocab_size
        self._max_pos = cfg.max_seq_len
        self.steps = 0

    def bind(self, engine, k: int):
        super().bind(engine, k)
        if self._vocab != engine._params["wte"].shape[0]:
            raise ValueError(
                f"draft vocab {self._vocab} != target vocab "
                f"{engine._params['wte'].shape[0]}: the drafter must "
                f"propose over the target's token space")
        if self._max_pos < engine._max_seq_len:
            raise ValueError(
                f"draft position table ({self._max_pos}) shorter than the "
                f"engine horizon ({engine._max_seq_len})")
        self._params = _tree_to(self._params, engine.device)
        if engine._weight_quant and "qkv_w" in self._params["blocks"][0]:
            self._params, mats, saved = _quantize_gpt_params(self._params)
            engine._add(weight_quant_mats=mats,
                        weight_quant_bytes_saved=saved)
        n_layers = len(self._params["blocks"])
        shape = _pool_shape(n_layers, self._num_heads, engine.pool.num_pages,
                            engine._page, self._head_dim)
        dtype = engine._k_pages.dtype
        self._k_pages = torch.zeros(shape, dtype=dtype, device=engine.device)
        self._v_pages = torch.zeros(shape, dtype=dtype, device=engine.device)
        self._k_scales = self._v_scales = None
        if engine._kv_quant:
            sshape = shape[:3]
            self._k_scales = torch.zeros(sshape, dtype=torch.float32,
                                         device=engine.device)
            self._v_scales = torch.zeros(sshape, dtype=torch.float32,
                                         device=engine.device)
        self._lens = np.zeros(engine._slots, np.int32)
        self._kw = dict(num_heads=self._num_heads, head_dim=self._head_dim,
                        eps=self._eps,
                        sampling=dict(sampler="greedy", temperature=1.0,
                                      top_k=0, top_p=1.0))
        if engine._kv_quant:
            self._kw.update(k_scales=self._k_scales, v_scales=self._v_scales)
        self._catch_fn = self._tracker(_gpt_spec_verify)
        self._step_fn = self._tracker(_gpt_decode_step)
        self._chunk_fn = self._scale_reset_fn = None
        self._prefill_fns = {}

    def _tracker(self, step) -> _StepGraph:
        """A `_StepGraph` of ``step`` over the draft's weights and pools
        (``draft_compiles``); the greedy draft draws nothing from the
        generator it is handed."""
        eng = self.engine
        params, kp, vp, gen, kw = (self._params, self._k_pages,
                                   self._v_pages, eng._generator, self._kw)
        return _StepGraph(lambda *inputs: step(params, kp, vp, *inputs, gen,
                                               **kw),
                          "draft_compiles", eng.device, eng._graph_memory)

    def _scale_reset_tracker(self) -> _StepGraph:
        if self._scale_reset_fn is None:
            self._scale_reset_fn = _scale_reset_graph(
                self._k_scales, self._v_scales, self.engine.device,
                self.engine._graph_memory)
        return self._scale_reset_fn

    def trackers(self):
        return [self._catch_fn, self._step_fn, self._chunk_fn,
                self._scale_reset_fn, *self._prefill_fns.values()]

    def _run(self, fn, *host) -> torch.Tensor:
        """One paged step of the draft (``fn`` a tracker of this
        drafter's)."""
        self.steps += 1
        return fn(*host)

    def on_admit(self, slot: int, req):
        eng = self.engine
        if eng._chunked:
            # the prompt arrives chunk by chunk (`ingest_chunks`) from the
            # first token past a cached prefix, whose draft K/V the
            # request that streamed those chunks wrote
            self._lens[slot] = req.cached_prefix_len
            return
        # legacy: the whole prompt in one draft prefill through the
        # slot's pages, bucketed as the engine's; its token is not read
        p_len = len(req.prompt_ids)
        bucket = eng._prefill_bucket(p_len)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :p_len] = req.prompt_ids
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._prefill_fns[bucket] = self._tracker(_gpt_prefill)
        t0 = time.perf_counter()
        fn(ids, np.asarray([p_len], np.int32), eng._bt[slot])
        eng._add(draft_time_s=time.perf_counter() - t0)
        self._lens[slot] = p_len

    def on_finish(self, slot: int, req):
        self._lens[slot] = 0

    def ingest_chunks(self, tokens, caps):
        eng = self.engine
        caps = np.asarray(caps, np.int32)
        if self._chunk_fn is None:
            self._chunk_fn = self._tracker(_gpt_mixed_step)
        t0 = time.perf_counter()
        # nothing is sampled, so nothing is fetched: no host sync
        self._run(self._chunk_fn, eng._bt, self._lens, tokens, caps,
                  np.zeros(eng._slots, np.int32),
                  np.zeros(eng._slots, bool))
        eng._add(draft_time_s=time.perf_counter() - t0)
        self._lens += caps

    def propose(self, write_caps) -> np.ndarray:
        eng = self.engine
        slots, k = eng._slots, self.k
        write_caps = np.asarray(write_caps)
        active = eng._active & (write_caps > 0)
        drafts = np.zeros((slots, k), np.int32)

        # catch-up: the tokens accepted since the draft last saw the slot
        # (positions lens_d .. L, L the last sampled token's), at most K+1
        catch = np.zeros((slots, k + 1), np.int32)
        caps = np.zeros(slots, np.int32)
        for s in np.nonzero(active)[0]:
            req = eng._by_slot[s]
            full = req.prompt_ids + req.output_ids
            pend = int(eng._lens[s]) + 1 - int(self._lens[s])
            assert 1 <= pend <= k + 1, (pend, k)
            catch[s, :pend] = full[self._lens[s]:self._lens[s] + pend]
            caps[s] = pend
        targets = eng._fetch(self._run(self._catch_fn, eng._bt, self._lens,
                                       catch, caps))
        self._lens[active] += caps[active]
        cur = np.where(active, targets[np.arange(slots),
                                       np.maximum(caps - 1, 0)],
                       0).astype(np.int32)
        drafts[:, 0] = cur

        # K-1 single-token steps; a slot takes part only while its write
        # position stays inside the window the engine reserved
        for i in range(1, k):
            step_active = active & (i <= write_caps - 1)
            if not step_active.any():
                break
            nxt = eng._fetch(self._run(self._step_fn, eng._bt, self._lens,
                                       cur, step_active)).astype(np.int32)
            self._lens[step_active] += 1
            cur = np.where(step_active, nxt, cur).astype(np.int32)
            drafts[:, i] = np.where(step_active, nxt, 0)
        return drafts

    def on_accept(self, slot: int, pos_before: int, n_emitted: int):
        # the draft K/V of the accepted drafts was computed under the
        # accepted prefix and stays; the rejected tail rolls back by the
        # length alone, and the correction or bonus token comes in with
        # the next catch-up
        self._lens[slot] = pos_before + min(n_emitted, self.k)


_DRAFTERS = {"prompt_lookup": PromptLookupDrafter}


def make_drafter(spec) -> Drafter:
    """An instance passes through; a name constructs
    (FLAGS_spec_drafter gives the default).  A draft model needs weights:
    pass a `DraftModelDrafter` instance."""
    if isinstance(spec, Drafter):
        return spec
    try:
        return _DRAFTERS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown drafter {spec!r}: pass one of {sorted(_DRAFTERS)} or "
            f"a Drafter instance") from None


# ---------------------------------------------------------------------------
# The propose -> verify -> accept round
# ---------------------------------------------------------------------------
class SpeculativeDecoder:
    """One speculative round an engine step: reserve each slot's verify
    window, draft, verify in one step, accept the matching prefix and one
    target token, roll the rest back by the length.

    With ``adaptive``, each slot's depth ``k_slot`` (at most K) halves
    toward ``FLAGS_spec_k_min`` after ``FLAGS_spec_k_shrink_streak``
    fully rejected rounds and grows by one after
    ``FLAGS_spec_k_grow_streak`` fully accepted ones: only the window's
    span changes, never a shape."""

    engine = _EngineRef()

    def __init__(self, engine, k: int, drafter=None, adaptive=False):
        if k < 1:
            raise ValueError(f"spec_decode_k must be >= 1, got {k}")
        self.engine = engine
        self.k = int(k)
        if drafter is None:
            drafter = str(_flags.flag("spec_drafter"))
        self.drafter = make_drafter(drafter)
        self.drafter.bind(engine, self.k)
        self.adaptive = bool(adaptive)
        self.k_min = min(self.k, max(1, int(_flags.flag("spec_k_min"))))
        self._shrink_after = max(1, int(_flags.flag("spec_k_shrink_streak")))
        self._grow_after = max(1, int(_flags.flag("spec_k_grow_streak")))
        self.k_slot = np.full(engine._slots, self.k, np.int32)
        self._rej_streak = np.zeros(engine._slots, np.int32)
        self._acc_streak = np.zeros(engine._slots, np.int32)
        self._verify_fn = None  # split path only: a ragged engine's step

    def trackers(self):
        """Every `_StepGraph` of the round's own (the engine's are
        counted by the engine)."""
        return [self._verify_fn, *getattr(self.drafter, "trackers",
                                          list)()]

    def _verify_tracker(self):
        eng = self.engine
        if eng._ragged:
            return eng._ragged_tracker()
        if self._verify_fn is None:
            self._verify_fn = eng._tracker(_gpt_spec_verify,
                                           "verify_compiles")
        return self._verify_fn

    def on_admit(self, slot: int, req):
        self._reset_k(slot)
        self.drafter.on_admit(slot, req)

    def on_finish(self, slot: int, req):
        self._reset_k(slot)
        self.drafter.on_finish(slot, req)

    def _reset_k(self, slot: int):
        """A learned depth belongs to the request that earned it."""
        self.k_slot[slot] = self.k
        self._rej_streak[slot] = 0
        self._acc_streak[slot] = 0

    def _grow_ok(self) -> bool:
        """The gate on depth growth.  JAX consults its cost model here
        and allows growth without one; the port has no cost model yet."""
        return True

    def _adapt_k(self, slot: int, m: int, usable: int):
        """Feed one round's acceptance (``m`` of ``usable`` drafts) to the
        slot's depth: a full rejection extends the rejection streak, a
        full acceptance the acceptance run, a partial one resets both."""
        if usable <= 0:
            return
        eng = self.engine
        if m == 0:
            self._acc_streak[slot] = 0
            self._rej_streak[slot] += 1
            if self._rej_streak[slot] >= self._shrink_after and \
                    int(self.k_slot[slot]) > self.k_min:
                self.k_slot[slot] = max(self.k_min,
                                        int(self.k_slot[slot]) // 2)
                self._rej_streak[slot] = 0
                eng._add(spec_k_shrinks=1)
        elif m >= usable:
            self._rej_streak[slot] = 0
            self._acc_streak[slot] += 1
            if self._acc_streak[slot] >= self._grow_after and \
                    int(self.k_slot[slot]) < self.k:
                self._acc_streak[slot] = 0
                if self._grow_ok():
                    self.k_slot[slot] += 1
                    eng._add(spec_k_grows=1)
        else:
            self._rej_streak[slot] = 0
            self._acc_streak[slot] = 0

    def step(self) -> bool:
        """One round over every active slot (`DecodeEngine.step`, after
        admission): prompt chunks first, through the engine's mixed (or
        ragged) step; then propose, verify and accept for every slot
        that is decoding."""
        eng = self.engine
        slots = eng._slots
        if eng._chunked and eng._prefilling_any():
            # a slot whose last chunk lands here joins this very round
            eng._mixed_step(decode_rows=False)

        # each decoding slot's window, clamped to its token budget: KV
        # rows past prompt + max_new - 2 are never needed
        caps = np.zeros(slots, np.int32)
        for s in range(slots):
            if not eng._active[s] or eng._is_prefilling(s):
                continue
            req = eng._by_slot[s]
            need = req.max_new_tokens - len(req.output_ids)
            k_s = int(self.k_slot[s]) if self.adaptive else self.k
            caps[s] = min(k_s + 1, need)
        if not caps.any():
            return True  # the chunk step was this engine step
        eng._grow_block_tables(writes=caps)
        eng._flush_fresh_scales()
        pos_before = eng._lens.copy()

        t0 = time.perf_counter()
        try:
            if eng._fault is not None:
                eng._resilience.fault_point("drafter")
            drafts = self.drafter.propose(caps)
        except eng._resilience.NONRETRYABLE:
            raise
        except Exception as e:
            # drafter containment: the round verifies zero drafts (all
            # rejected, one target token a slot: no new shape); repeated
            # faults degrade speculation off
            if not eng._resilience.contain(e):
                raise
            drafts = np.zeros((slots, self.k), np.int32)
            eng._resilience.on_drafter_fault(e)
        t_draft = time.perf_counter() - t0

        tokens = np.concatenate([eng._last[:, None].astype(np.int32),
                                 drafts], axis=1)
        width = eng._q_ragged if eng._ragged else self.k + 1
        if tokens.shape[1] < width:
            # the ragged grid's padding columns sit past every cap
            tokens = np.pad(tokens, ((0, 0), (0, width - tokens.shape[1])))
        fn = self._verify_tracker()
        if eng._fault is not None:
            eng._resilience.step_fault_point("verify")
        eng._step_no += 1
        t0 = time.perf_counter()
        targets = eng._fetch(fn(eng._bt, eng._lens, tokens, caps))
        t_verify = time.perf_counter() - t0
        if eng._fault is not None:
            targets = eng._resilience.corrupt_tokens(
                targets, [s for s in range(slots) if caps[s] > 0])
        n_active = int(eng._active.sum())

        emitted_total = proposed_total = accepted_total = 0
        for s in range(slots):
            if not eng._active[s] or caps[s] == 0:
                continue
            req = eng._by_slot[s]
            w = int(caps[s])
            usable = min(self.k, w - 1)
            m = 0
            while m < usable and int(drafts[s, m]) == int(targets[s, m]):
                m += 1
            emit = [int(t) for t in drafts[s, :m]] + [int(targets[s, m])]
            if any(t < 0 for t in emit):
                # non-finite logits in this slot's window: quarantine it
                # without emitting; the other slots' rounds stand
                eng._quarantine_slot(s, "nan_logits")
                continue
            if req.eos_token_id is not None:
                for j, t in enumerate(emit):
                    if t == req.eos_token_id:
                        emit = emit[:j + 1]
                        break
            n_emit = len(emit)
            # after the eos cut, so acceptance stays consistent with what
            # reached the output
            proposed_total += usable
            accepted_total += min(m, n_emit)
            eng._emit(req, emit)
            eng._lens[s] += n_emit
            eng._last[s] = emit[-1]
            emitted_total += n_emit
            eng._register_generated_pages(s, req)
            self.drafter.on_accept(s, int(pos_before[s]), n_emit)
            if self.adaptive:
                self._adapt_k(s, m, usable)
            reason = eng._done(req, emit[-1])
            if reason:
                eng._finish(s, reason)

        eng._add(spec_steps=1, ragged_steps=int(eng._ragged),
                 spec_slot_steps=int((caps > 0).sum()), steps=1,
                 spec_proposed=proposed_total, spec_accepted=accepted_total,
                 spec_emitted=emitted_total, tokens=emitted_total,
                 draft_time_s=t_draft, verify_time_s=t_verify,
                 decode_time_s=t_draft + t_verify,
                 occupancy_sum=n_active / slots,
                 kv_util_sum=eng.pool.utilization())
        eng._observe_step()
        return True
