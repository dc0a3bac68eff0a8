"""The port's admission schedulers and asyncio front-end
(`paddle_tpu_torch.inference.frontend`) against the JAX package's.

The scenarios are tests/test_frontend.py's, at its tiny config: each
runs on the JAX engine and on the port's engine (``device="cpu"``) over
the same weights, and the greedy tokens, finish reasons, request states
along the way and the scheduler counters must agree.  The front-end's
own mechanics (cancellation, backpressure, shutdown, a dying driver) are
host code and run on the port alone.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import asyncio
import time

import numpy as np
import pytest

from torch_reliability_common import both, port, prompt, run

KW = dict(max_batch_size=2, max_seq_len=48, page_size=4,
          prefill_chunk_tokens=8)
SCHED_KEYS = ("preemptions", "resumes", "deadline_expired",
              "slo_violations", "cancelled", "evicted", "finished_length",
              "retraces_after_warmup")


def _both(fn, seed):
    return both(fn, seed=seed, **KW)


# ---------------------------------------------------------------------------
# scheduler plumbing
# ---------------------------------------------------------------------------
class TestSchedulerPlumbing:
    def test_default_is_fifo_and_flag_resolution(self):
        sd = port(**KW)
        assert isinstance(sd.engine()._scheduler, sd.F.FIFOScheduler)
        assert isinstance(sd.engine(scheduler="slo")._scheduler,
                          sd.F.SLOScheduler)
        sched = sd.F.SLOScheduler(hol_skip_limit=1)
        assert sd.engine(scheduler=sched)._scheduler is sched
        with sd.flags(sched_policy="slo"):
            assert isinstance(sd.engine()._scheduler, sd.F.SLOScheduler)

    def test_make_scheduler_rejects_unknown(self):
        sd = port()
        with pytest.raises(ValueError, match="unknown scheduler"):
            sd.F.make_scheduler("lifo")

    def test_rebind_refused(self):
        sd = port(**KW)
        sched = sd.F.SLOScheduler()
        sd.engine(scheduler=sched)
        with pytest.raises(ValueError, match="already bound"):
            sd.engine(scheduler=sched)

    def test_base_scheduler_is_abstract(self):
        with pytest.raises(NotImplementedError):
            port().F.Scheduler().schedule()

    def test_request_validation(self):
        sd = port()
        with pytest.raises(ValueError, match="deadline_ms"):
            sd.S.Request(np.arange(4), deadline_ms=0)
        with pytest.raises(ValueError, match="hol_skip_limit"):
            sd.F.SLOScheduler(hol_skip_limit=-1)
        with pytest.raises(ValueError, match="preempt_min_output"):
            sd.F.SLOScheduler(preempt_min_output=0)
        assert sd.S.Request(np.arange(4)).priority == sd.S.PRIORITY_BATCH


class TestParity:
    def test_fifo_vs_slo_greedy_parity_and_no_new_executables(self):
        def scen(sd):
            rng = np.random.RandomState(7)
            prompts = [prompt(rng, 6 + i) for i in range(4)]
            outs_f = sd.engine().generate(prompts, max_new_tokens=8)
            st_f = sd.S.decode_stats(reset=True)
            outs_s = sd.engine(scheduler="slo").generate(prompts,
                                                         max_new_tokens=8)
            st_s = sd.stats()
            assert outs_f == outs_s
            keys = ("mixed_compiles", "decode_compiles", "prefill_compiles")
            assert [st_s[k] for k in keys] == [st_f[k] for k in keys]
            assert st_f["retraces_after_warmup"] == 0
            assert st_s["retraces_after_warmup"] == 0
            assert st_s["preemptions"] == 0
            return outs_f, [st_f[k] for k in keys]

        j, t = _both(scen, 3)
        assert j == t


class TestDeadline:
    def test_queued_expiry_never_takes_a_slot(self):
        def scen(sd):
            rng = np.random.RandomState(0)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            busy = eng.add_request(prompt(rng), max_new_tokens=6)
            doomed = eng.add_request(prompt(rng), max_new_tokens=6,
                                     deadline_ms=0.01)
            time.sleep(0.001)
            eng.run()
            assert doomed.t_admit_ns is None and doomed.output_ids == []
            assert not doomed.slo_met
            assert eng.pool.available_count == eng.pool.num_pages
            return (busy.finish_reason, busy.generated_ids,
                    doomed.finish_reason, sd.stats()["deadline_expired"])

        j, t = _both(scen, 4)
        assert j == t and t[2] == "deadline" and t[3] == 1

    def test_fifo_never_expires(self):
        def scen(sd):
            rng = np.random.RandomState(0)
            eng = sd.engine(max_batch_size=1)
            eng.add_request(prompt(rng), max_new_tokens=4)
            late = eng.add_request(prompt(rng), max_new_tokens=4,
                                   deadline_ms=0.01)
            time.sleep(0.001)
            eng.run()
            assert not late.slo_met
            return late.finish_reason, late.slo_violations

        j, t = _both(scen, 4)
        assert j == t == ("length", ["deadline"])

    def test_resumed_request_is_exempt_from_expiry(self):
        def scen(sd):
            rng = np.random.RandomState(1)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            # admitted at the first step, well inside its deadline even
            # on a loaded machine; the deadline is gone before the preempt
            victim = eng.add_request(prompt(rng), max_new_tokens=12,
                                     deadline_ms=50.0)
            for _ in range(6):
                eng.step()
            assert victim.state == "running" and victim.output_ids
            time.sleep(0.06)
            urgent = eng.add_request(prompt(rng), max_new_tokens=2,
                                     priority=sd.S.PRIORITY_INTERACTIVE)
            eng.run()
            return (urgent.finish_reason, victim.preemptions,
                    victim.finish_reason, victim.slo_violations,
                    victim.generated_ids)

        j, t = _both(scen, 5)
        assert j == t
        assert t[:4] == ("length", 1, "length", ["deadline"])


class TestPriorityOrdering:
    def test_interactive_admitted_before_earlier_batch(self):
        def scen(sd):
            rng = np.random.RandomState(2)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            runner = eng.add_request(prompt(rng), max_new_tokens=6,
                                     priority=sd.S.PRIORITY_INTERACTIVE)
            batch = eng.add_request(prompt(rng), max_new_tokens=4)
            inter = eng.add_request(prompt(rng), max_new_tokens=4,
                                    priority=sd.S.PRIORITY_INTERACTIVE)
            while runner.state != "done":
                eng.step()
            states = [(batch.state, inter.state)]
            eng.step()
            states.append((batch.state, inter.state))
            eng.run()
            return states, batch.generated_ids, inter.generated_ids

        j, t = _both(scen, 6)
        assert j == t
        assert t[0] == [("queued", "queued"), ("queued", "running")]

    def test_edf_inside_a_class(self):
        def scen(sd):
            rng = np.random.RandomState(3)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            runner = eng.add_request(prompt(rng), max_new_tokens=6,
                                     priority=sd.S.PRIORITY_INTERACTIVE)
            none = eng.add_request(prompt(rng), max_new_tokens=4)
            loose = eng.add_request(prompt(rng), max_new_tokens=4,
                                    deadline_ms=60_000.0)
            tight = eng.add_request(prompt(rng), max_new_tokens=4,
                                    deadline_ms=30_000.0)
            order = []
            while any(r.state != "done"
                      for r in (runner, none, loose, tight)):
                eng.step()
                for name, r in (("none", none), ("loose", loose),
                                ("tight", tight)):
                    if r.state == "running" and name not in order:
                        order.append(name)
            return order, none.finish_reason

        j, t = _both(scen, 6)
        assert j == t == (["tight", "loose", "none"], "length")


class TestPreemptResume:
    def test_resume_matches_never_preempted_run(self):
        def scen(sd):
            rng = np.random.RandomState(4)
            p = prompt(rng, 10)
            ref = sd.engine(max_batch_size=1).generate(
                [p], max_new_tokens=20)[0]
            sd.reset()
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            victim = eng.add_request(p, max_new_tokens=20)
            for _ in range(8):
                eng.step()
            assert victim.state == "running"
            urgent = eng.add_request(prompt(rng, 6), max_new_tokens=3,
                                     priority=sd.S.PRIORITY_INTERACTIVE)
            eng.step()
            assert victim.state == "queued" and victim.preemptions == 1
            assert urgent.state == "running"
            eng.run()
            st = sd.stats()
            assert victim.generated_ids == ref
            assert len(victim.output_ids) < len(victim.generated_ids)
            assert st["prefix_hits"] >= 1
            assert eng.pool.available_count == eng.pool.num_pages
            return (victim.generated_ids, urgent.generated_ids,
                    st["prefix_hits"], {k: st[k] for k in SCHED_KEYS})

        j, t = _both(scen, 7)
        assert j == t
        assert (t[3]["preemptions"], t[3]["resumes"]) == (1, 1)

    def test_no_preemption_when_it_cannot_admit_the_candidate(self):
        def scen(sd):
            rng = np.random.RandomState(8)
            eng = sd.engine(scheduler="slo", num_pages=16)
            a = eng.add_request(prompt(rng), max_new_tokens=30,
                                priority=sd.S.PRIORITY_INTERACTIVE)
            b = eng.add_request(prompt(rng), max_new_tokens=6)
            for _ in range(4):
                eng.step()
            assert b.output_ids
            c = eng.add_request(prompt(rng), max_new_tokens=18,
                                priority=sd.S.PRIORITY_INTERACTIVE)
            eng.step()
            state_b = b.state
            eng.run()
            return (state_b, sd.stats()["preemptions"], c.finish_reason,
                    [r.generated_ids for r in (a, b, c)])

        j, t = _both(scen, 9)
        assert j == t and t[:3] == ("running", 0, "length")

    def test_legacy_prefill_resume_keeps_ttft_and_tokens(self):
        def scen(sd):
            rng = np.random.RandomState(7)
            p = prompt(rng, 10)
            ref = sd.engine(max_batch_size=1, chunked_prefill=False
                            ).generate([p], max_new_tokens=12)[0]
            sd.reset()
            eng = sd.engine(max_batch_size=1, chunked_prefill=False)
            req = eng.add_request(p, max_new_tokens=12)
            eng.step()
            t_first = req.t_first_token_ns
            assert t_first is not None
            n_ttft = sd.obs.REQUEST_TTFT.series_state()["count"]
            eng.preempt(req)
            eng.run()
            assert req.t_first_token_ns == t_first
            assert sd.obs.REQUEST_TTFT.series_state()["count"] == n_ttft
            assert req.generated_ids == ref
            return req.generated_ids, sd.stats()["resumes"]

        j, t = _both(scen, 9)
        assert j == t and t[1] == 1

    def test_no_preemption_without_better_priority(self):
        def scen(sd):
            rng = np.random.RandomState(5)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            runner = eng.add_request(prompt(rng), max_new_tokens=10)
            for _ in range(6):
                eng.step()
            eng.add_request(prompt(rng), max_new_tokens=2)
            eng.run()
            return sd.stats()["preemptions"], runner.finish_reason

        j, t = _both(scen, 7)
        assert j == t == (0, "length")

    def test_streaming_sees_each_token_once_across_preemption(self):
        def scen(sd):
            rng = np.random.RandomState(6)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            seen = []
            victim = eng.add_request(prompt(rng), max_new_tokens=16,
                                     on_token=seen.append)
            for _ in range(8):
                eng.step()
            eng.add_request(prompt(rng, 6), max_new_tokens=2,
                            priority=sd.S.PRIORITY_INTERACTIVE)
            eng.run()
            assert victim.preemptions == 1
            assert seen == victim.generated_ids
            return seen

        j, t = _both(scen, 8)
        assert j == t

    def test_spec_decode_composes_with_preemption(self):
        def scen(sd):
            rng = np.random.RandomState(7)
            base = prompt(rng, 6)
            p = np.concatenate([base, base])
            ref = sd.engine(max_batch_size=1).generate(
                [p], max_new_tokens=24)[0]
            sd.reset()
            eng = sd.engine(max_batch_size=1, scheduler="slo",
                            spec_decode_k=2)
            victim = eng.add_request(p, max_new_tokens=24)
            for _ in range(4):
                eng.step()
            assert victim.state == "running" and victim.output_ids
            eng.add_request(prompt(rng, 4), max_new_tokens=2,
                            priority=sd.S.PRIORITY_INTERACTIVE)
            eng.run()
            st = sd.stats()
            assert victim.generated_ids == ref
            assert eng.pool.available_count == eng.pool.num_pages
            return (victim.generated_ids, st["preemptions"],
                    st["retraces_after_warmup"], st["spec_steps"])

        j, t = _both(scen, 9)
        assert j == t and t[1:3] == (1, 0)


class TestHeadOfLine:
    def _pressure_engine(self, sd):
        return sd.engine(num_pages=10,
                         scheduler=sd.F.SLOScheduler(hol_skip_limit=2))

    def test_skip_admits_smaller_then_fence_stops_starvation(self):
        def scen(sd):
            rng = np.random.RandomState(8)
            eng = self._pressure_engine(sd)
            runner = eng.add_request(prompt(rng, 4), max_new_tokens=13)
            eng.step()
            big = eng.add_request(prompt(rng, 8), max_new_tokens=20)
            smalls = [eng.add_request(prompt(rng, 4), max_new_tokens=2)
                      for _ in range(4)]
            for _ in range(3):
                eng.step()
            mid = (big.state, [s.state for s in smalls])
            eng.run()
            assert big._hol_skips <= 2
            assert eng.pool.available_count == eng.pool.num_pages
            return (mid, big._hol_skips,
                    [r.finish_reason for r in [runner, big, *smalls]],
                    big.generated_ids)

        j, t = _both(scen, 10)
        assert j == t
        assert t[0][0] == "queued" and "running" in t[0][1] + ["done"]
        assert set(t[2]) == {"length"}

    def test_fence_freezes_admission_past_blocked_head(self):
        def scen(sd):
            rng = np.random.RandomState(9)
            eng = self._pressure_engine(sd)
            runner = eng.add_request(prompt(rng, 4), max_new_tokens=13)
            eng.step()
            big = eng.add_request(prompt(rng, 8), max_new_tokens=20)
            smalls = [eng.add_request(prompt(rng, 4), max_new_tokens=2)
                      for _ in range(6)]
            trace = []
            while runner.state == "running":
                eng.step()
                trace.append((big.state, big._hol_skips,
                              sum(s.state == "queued" for s in smalls)))
                if big._hol_skips >= 2:
                    break
            if big.state == "queued" and big._hol_skips >= 2:
                queued_before = [s for s in smalls if s.state == "queued"]
                eng.step()
                if big.state == "queued":
                    assert [s for s in queued_before
                            if s.state == "queued"] == queued_before
            eng.run()
            return trace, big.finish_reason

        j, t = _both(scen, 10)
        assert j == t and t[1] == "length"


class TestCancel:
    def test_cancel_labels_queued_vs_running_vs_evicted(self):
        def scen(sd):
            rng = np.random.RandomState(10)
            eng = sd.engine(max_batch_size=1)
            running = eng.add_request(prompt(rng), max_new_tokens=8)
            queued = eng.add_request(prompt(rng), max_new_tokens=8)
            evictee = eng.add_request(prompt(rng), max_new_tokens=8)
            eng.step()
            assert running.state == "running"
            queued.cancel()
            running.cancel()
            eng.evict(evictee)
            assert eng.pool.available_count == eng.pool.num_pages
            st = sd.stats()
            return ([r.finish_reason for r in (queued, running, evictee)],
                    st["cancelled"], st["evicted"])

        j, t = _both(scen, 11)
        assert j == t == (["cancelled", "cancelled", "evicted"], 2, 1)

    def test_running_cancel_keeps_partial_output(self):
        def scen(sd):
            rng = np.random.RandomState(11)
            eng = sd.engine(max_batch_size=1)
            req = eng.add_request(prompt(rng), max_new_tokens=16)
            for _ in range(6):
                eng.step()
            n = len(req.output_ids)
            req.cancel()
            assert len(req.output_ids) == n >= 1
            assert not req.slo_met
            return req.finish_reason, req.output_ids

        j, t = _both(scen, 11)
        assert j == t and t[0] == "cancelled"


class TestQueueGauges:
    def test_depth_and_oldest_age_sampled_in_step(self):
        def scen(sd):
            rng = np.random.RandomState(12)
            eng = sd.engine(max_batch_size=1)
            for _ in range(3):
                eng.add_request(prompt(rng), max_new_tokens=6)
            eng.step()
            eid = eng._engine_id
            depth = sd.obs.QUEUE_DEPTH.value(engine=eid)
            assert sd.obs.QUEUE_OLDEST_AGE.value(engine=eid) > 0
            eng.run()
            eng.step()  # one idle step samples the drained queue
            return (depth, sd.obs.QUEUE_DEPTH.value(engine=eid),
                    sd.obs.QUEUE_OLDEST_AGE.value(engine=eid))

        j, t = _both(scen, 12)
        assert j == t == (2, 0, 0)


class TestSLOAccounting:
    def test_ttft_violation_recorded_never_aborts(self):
        def scen(sd):
            rng = np.random.RandomState(13)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            req = eng.add_request(prompt(rng), max_new_tokens=4,
                                  slo_ttft_ms=1e-6, slo_tpot_ms=1e-6)
            eng.run()
            assert not req.slo_met
            return (req.finish_reason, sorted(req.slo_violations),
                    sd.stats()["slo_violations"])

        j, t = _both(scen, 13)
        assert j == t == ("length", ["tpot", "ttft"], 2)

    def test_ttft_violation_on_legacy_prefill_path(self):
        def scen(sd):
            rng = np.random.RandomState(17)
            eng = sd.engine(max_batch_size=1, chunked_prefill=False,
                            scheduler="slo")
            req = eng.add_request(prompt(rng), max_new_tokens=4,
                                  slo_ttft_ms=1e-6)
            eng.run()
            return req.finish_reason, req.slo_violations, req.slo_met

        j, t = _both(scen, 13)
        assert j == t == ("length", ["ttft"], False)

    def test_slo_met_when_targets_hold(self):
        def scen(sd):
            rng = np.random.RandomState(14)
            eng = sd.engine(max_batch_size=1, scheduler="slo")
            req = eng.add_request(prompt(rng), max_new_tokens=4,
                                  slo_ttft_ms=60_000.0,
                                  slo_tpot_ms=60_000.0,
                                  deadline_ms=60_000.0)
            eng.run()
            return req.slo_met, sd.stats()["slo_violations"]

        j, t = _both(scen, 13)
        assert j == t == (True, 0)


class TestAdaptiveChunkBudget:
    def test_budget_shrinks_under_tpot_pressure_and_recovers(self):
        def scen(sd):
            rng = np.random.RandomState(15)
            eng = sd.engine(scheduler=sd.F.SLOScheduler(chunk_budget_min=2))
            sched, base = eng._scheduler, eng._chunk_budget
            req = eng.add_request(prompt(rng), max_new_tokens=4,
                                  slo_tpot_ms=1e-9)
            eng.step()
            sd.obs.REQUEST_TPOT.observe(0.5)
            sched._adapt_budget()
            shrunk = eng._chunk_budget
            req.cancel()
            eng.add_request(prompt(rng), max_new_tokens=2)
            sd.obs.REQUEST_TPOT.observe(0.001)
            sched._adapt_budget()
            grown = eng._chunk_budget
            eng.run()
            assert sd.stats()["retraces_after_warmup"] == 0
            return base, shrunk, grown

        j, t = _both(scen, 14)
        assert j == t == (8, 4, 8)

    def test_budget_controller_survives_registry_reset(self):
        def scen(sd):
            rng = np.random.RandomState(18)
            eng = sd.engine(scheduler=sd.F.SLOScheduler(chunk_budget_min=2))
            sched = eng._scheduler
            req = eng.add_request(prompt(rng), max_new_tokens=4,
                                  slo_tpot_ms=1e-9)
            eng.step()
            sd.obs.REQUEST_TPOT.observe(0.5)
            sched._adapt_budget()
            seq = [eng._chunk_budget]
            sd.obs.reset()
            sched._adapt_budget()
            seq.append(eng._chunk_budget)
            req.cancel()
            eng.add_request(prompt(rng), max_new_tokens=2)
            sd.obs.REQUEST_TPOT.observe(0.001)
            sched._adapt_budget()
            seq.append(eng._chunk_budget)
            eng.run()
            return seq

        j, t = _both(scen, 14)
        assert j == t == [4, 4, 8]

    def test_budget_never_below_floor(self):
        sd = port(seed=14, **KW)
        rng = np.random.RandomState(16)
        eng = sd.engine(scheduler=sd.F.SLOScheduler(chunk_budget_min=4))
        eng.add_request(prompt(rng), max_new_tokens=4, slo_tpot_ms=1e-9)
        eng.step()
        for _ in range(6):
            sd.obs.REQUEST_TPOT.observe(0.5)
            eng._scheduler._adapt_budget()
        assert eng._chunk_budget >= 4


class TestRunGenerate:
    def test_run_raises_at_step_cap_instead_of_truncating(self):
        sd = port(seed=15, **KW)
        eng = sd.engine(max_batch_size=1)
        eng.add_request(prompt(np.random.RandomState(17)),
                        max_new_tokens=16)
        with pytest.raises(RuntimeError, match="max_steps"):
            eng.run(max_steps=2)
        eng.run()

    def test_generate_returns_preemption_stable_ids(self):
        def scen(sd):
            rng = np.random.RandomState(18)
            prompts = [prompt(rng, 6) for _ in range(3)]
            return sd.engine().generate(prompts, max_new_tokens=5,
                                        return_meta=True)

        j, t = _both(scen, 15)
        assert j == t and t[1] == ["length"] * 3


# ---------------------------------------------------------------------------
# the asyncio front-end
# ---------------------------------------------------------------------------
class TestServingFrontend:
    def test_stream_matches_blocking_generate(self):
        def scen(sd):
            rng = np.random.RandomState(20)
            p = prompt(rng)
            ref = sd.engine().generate([p], max_new_tokens=8)[0]

            async def go():
                async with sd.F.ServingFrontend(sd.engine()) as fe:
                    stream = await fe.submit(p, max_new_tokens=8)
                    toks = await stream.collect()
                assert stream.finish_reason == "length"
                assert stream.generated_ids == toks
                return toks

            toks = run(go())
            assert toks == ref
            return toks

        j, t = _both(scen, 16)
        assert j == t

    def test_interactive_first_token_before_batch_completion(self):
        sd = port(seed=17, **KW)
        rng = np.random.RandomState(21)
        prompts = [prompt(rng) for _ in range(3)]

        async def go():
            eng = sd.engine(scheduler="slo")
            events = []

            async def consume(name, stream):
                first = True
                async for _ in stream:
                    if first:
                        events.append(("first", name))
                        first = False
                events.append(("done", name))

            async with sd.F.ServingFrontend(eng) as fe:
                tasks = []
                for i in range(2):
                    s = await fe.submit(prompts[i], max_new_tokens=40)
                    tasks.append(asyncio.create_task(
                        consume(f"batch{i}", s)))
                # both batches mid-generation (a fixed sleep raced a fast
                # CPU: the batches could finish inside it)
                while len(events) < 2:
                    await asyncio.sleep(0.001)
                s = await fe.submit(prompts[2], max_new_tokens=4,
                                    priority=sd.S.PRIORITY_INTERACTIVE)
                tasks.append(asyncio.create_task(consume("inter", s)))
                await asyncio.gather(*tasks)
            first_inter = events.index(("first", "inter"))
            batch_done = min(i for i, e in enumerate(events)
                             if e in (("done", "batch0"), ("done", "batch1")))
            assert first_inter < batch_done, events
            assert eng.pool.available_count == eng.pool.num_pages

        run(go())

    def test_cancel_midstream_frees_slot_and_pages(self):
        sd = port(seed=18, **KW)
        p = prompt(np.random.RandomState(22))

        async def go():
            eng = sd.engine(max_batch_size=1)
            async with sd.F.ServingFrontend(eng) as fe:
                stream = await fe.submit(p, max_new_tokens=30)
                got = []
                async for tok in stream:
                    got.append(tok)
                    if len(got) == 3:
                        await stream.cancel()
                assert stream.finish_reason == "cancelled"
                assert 3 <= len(got) < 30
                nxt = await fe.submit(p, max_new_tokens=2)
                assert len(await nxt.collect()) == 2
            assert eng.pool.available_count == eng.pool.num_pages
            assert sd.stats()["cancelled"] == 1

        run(go())

    def test_cancel_while_queued(self):
        sd = port(seed=18, **KW)
        rng = np.random.RandomState(23)

        async def go():
            async with sd.F.ServingFrontend(
                    sd.engine(max_batch_size=1)) as fe:
                s1 = await fe.submit(prompt(rng), max_new_tokens=10)
                s2 = await fe.submit(prompt(rng), max_new_tokens=10)
                await s2.cancel()
                assert await s2.collect() == []
                assert s2.finish_reason == "cancelled"
                assert len(await s1.collect()) == 10

        run(go())

    def test_stream_backpressure_pauses_engine(self):
        sd = port(seed=19, **KW)
        rng = np.random.RandomState(24)

        async def go():
            async with sd.F.ServingFrontend(sd.engine(max_batch_size=1),
                                            stream_buffer=2) as fe:
                stream = await fe.submit(prompt(rng), max_new_tokens=12)
                for _ in range(60):
                    await asyncio.sleep(0.005)
                    if stream.pending >= 2:
                        break
                await asyncio.sleep(0.05)
                assert stream.pending <= 3
                assert len(await stream.collect()) == 12

        run(go())

    def test_submit_backpressure_bounds_admission_queue(self):
        sd = port(seed=19, **KW)
        rng = np.random.RandomState(25)

        async def go():
            eng = sd.engine(max_batch_size=1)
            async with sd.F.ServingFrontend(eng, max_queue_depth=1) as fe:
                streams = []
                for _ in range(4):
                    streams.append(await fe.submit(prompt(rng),
                                                   max_new_tokens=4))
                    assert len(eng._queue) <= 1
                outs = [await s.collect() for s in streams]
            assert all(len(o) == 4 for o in outs)

        run(go())

    def test_close_drain_serves_everything(self):
        sd = port(seed=20, **KW)
        rng = np.random.RandomState(26)

        async def go():
            fe = sd.F.ServingFrontend(sd.engine())
            s1 = await fe.submit(prompt(rng), max_new_tokens=6)
            s2 = await fe.submit(prompt(rng), max_new_tokens=6)
            await fe.close(drain=True)
            assert s1.finish_reason == s2.finish_reason == "length"
            assert len(await s1.collect()) == len(await s2.collect()) == 6
            with pytest.raises(RuntimeError, match="clos"):
                await fe.submit(prompt(rng))

        run(go())

    def test_close_no_drain_cancels_outstanding(self):
        sd = port(seed=20, **KW)
        rng = np.random.RandomState(27)

        async def go():
            eng = sd.engine(max_batch_size=1)
            fe = sd.F.ServingFrontend(eng)
            s1 = await fe.submit(prompt(rng), max_new_tokens=38)
            s2 = await fe.submit(prompt(rng), max_new_tokens=38)
            while s1.pending < 1:  # s1 mid-generation
                await asyncio.sleep(0.001)
            await fe.close(drain=False)
            assert s1.finish_reason == s2.finish_reason == "cancelled"
            assert eng.pool.available_count == eng.pool.num_pages

        run(go())

    def test_submit_raises_on_dead_driver_with_full_queue(self):
        sd = port(seed=24, **KW)
        rng = np.random.RandomState(33)

        async def go():
            eng = sd.engine(max_batch_size=1)
            calls = {"n": 0}
            orig_step = eng.step

            def step():
                calls["n"] += 1
                if calls["n"] >= 3:
                    raise RuntimeError("boom")
                return orig_step()

            eng.step = step
            fe = sd.F.ServingFrontend(eng, max_queue_depth=1)
            s1 = await fe.submit(prompt(rng), max_new_tokens=10)
            s2 = await fe.submit(prompt(rng), max_new_tokens=10)
            await asyncio.wait_for(s1.collect(), 10)
            assert s2.request.state == "queued"
            with pytest.raises(RuntimeError, match="driver"):
                await asyncio.wait_for(fe.submit(prompt(rng)), 10)
            with pytest.raises(RuntimeError, match="boom"):
                await fe.close()

        run(go(), timeout=30)

    def test_close_no_drain_rejects_unapplied_submission(self):
        sd = port(seed=24, **KW)
        rng = np.random.RandomState(32)

        async def go():
            eng = sd.engine(max_batch_size=1)
            fe = sd.F.ServingFrontend(eng)
            s1 = await fe.submit(prompt(rng), max_new_tokens=30)
            racer = asyncio.create_task(
                fe.submit(prompt(rng), max_new_tokens=30))
            await asyncio.sleep(0)
            await asyncio.wait_for(fe.close(drain=False), 10)
            assert s1.finish_reason == "cancelled"
            try:
                s2 = await racer
            except RuntimeError as e:
                assert "closing" in str(e)
            else:
                assert s2.finish_reason == "cancelled"
            assert eng.pool.available_count == eng.pool.num_pages

        run(go(), timeout=30)

    def test_submit_surfaces_validation_errors(self):
        sd = port(seed=21, **KW)

        async def go():
            async with sd.F.ServingFrontend(sd.engine()) as fe:
                with pytest.raises(ValueError, match="empty prompt"):
                    await fe.submit(np.zeros((0,), np.int32))

        run(go())

    def test_constructor_validation(self):
        sd = port(seed=21, **KW)
        eng = sd.engine()
        with pytest.raises(ValueError, match="max_queue_depth"):
            sd.F.ServingFrontend(eng, max_queue_depth=0)
        with pytest.raises(ValueError, match="stream_buffer"):
            sd.F.ServingFrontend(eng, stream_buffer=0)

    def test_cancel_while_paused_on_backpressure(self):
        sd = port(seed=22, **KW)
        rng = np.random.RandomState(28)

        async def go():
            eng = sd.engine(max_batch_size=1)
            async with sd.F.ServingFrontend(eng, stream_buffer=1) as fe:
                stream = await fe.submit(prompt(rng), max_new_tokens=20)
                for _ in range(200):
                    await asyncio.sleep(0.005)
                    if stream.pending >= 1:
                        break
                await asyncio.wait_for(stream.cancel(), 10)
                got = await stream.collect()
                assert stream.finish_reason == "cancelled"
                assert 1 <= len(got) < 20
            assert eng.pool.available_count == eng.pool.num_pages

        run(go(), timeout=30)

    def test_close_no_drain_while_paused_on_backpressure(self):
        sd = port(seed=22, **KW)
        rng = np.random.RandomState(29)

        async def go():
            eng = sd.engine(max_batch_size=1)
            fe = sd.F.ServingFrontend(eng, stream_buffer=1)
            stream = await fe.submit(prompt(rng), max_new_tokens=20)
            for _ in range(200):
                await asyncio.sleep(0.005)
                if stream.pending >= 1:
                    break
            await asyncio.wait_for(fe.close(drain=False), 10)
            assert stream.finish_reason == "cancelled"
            assert eng.pool.available_count == eng.pool.num_pages

        run(go(), timeout=30)

    def test_concurrent_submits_respect_queue_bound(self):
        sd = port(seed=23, **KW)
        rng = np.random.RandomState(30)

        async def go():
            eng = sd.engine(max_batch_size=1)
            depth_seen = []
            orig_step = eng.step

            def step():
                depth_seen.append(len(eng._queue))
                out = orig_step()
                depth_seen.append(len(eng._queue))
                return out

            eng.step = step
            async with sd.F.ServingFrontend(eng, max_queue_depth=2) as fe:
                streams = await asyncio.gather(
                    *[fe.submit(prompt(rng), max_new_tokens=3)
                      for _ in range(6)])
                outs = await asyncio.gather(*[s.collect() for s in streams])
            assert all(len(o) == 3 for o in outs)
            assert max(depth_seen) <= 2

        run(go())

    def test_step_exception_ends_streams_and_surfaces(self):
        sd = port(seed=23, **KW)
        rng = np.random.RandomState(31)

        async def go():
            eng = sd.engine(max_batch_size=1)
            calls = {"n": 0}
            orig_step = eng.step

            def step():
                calls["n"] += 1
                if calls["n"] >= 2:
                    raise RuntimeError("boom")
                return orig_step()

            eng.step = step
            fe = sd.F.ServingFrontend(eng)
            stream = await fe.submit(prompt(rng), max_new_tokens=10)
            got = await asyncio.wait_for(stream.collect(), 10)
            assert len(got) < 10
            with pytest.raises(RuntimeError, match="driver"):
                await fe.submit(prompt(rng))
            with pytest.raises(RuntimeError, match="boom"):
                await fe.close()

        run(go(), timeout=30)
