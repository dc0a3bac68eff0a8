"""The port's containment ladder and in-process recovery
(`paddle_tpu_torch.inference.resilience`) against the JAX package's.

The scenarios are tests/test_resilience.py's, at its tiny config: each
fault plan runs on the JAX engine and on the port's engine
(``device="cpu"``) over the same weights, and the greedy tokens, finish
reasons, `FaultInfo` records and the ladder's counters must agree.  The
port's own concerns are held here too: a step retried after it wrote
int8 KV leaves the pools bit-equal to a clean step's (in-place writes
where JAX returns new buffers), the disarmed engine serves exactly as
before, a handoff recovery allocates nothing, the card's containment rule
(only injected faults; rehearsed on the CPU) lets any other exception
out of the step, and on the card a retried step replays its captured
graph.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import pytest
import torch

from torch_reliability_common import (both, fault_dict, port, run)

KW = dict(max_batch_size=2, max_seq_len=96, page_size=4)
PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2],
           [7, 8, 9, 7, 8, 9, 7, 8]]
NEW = 16
LADDER = ("step_retries", "faults_injected", "finished_fault",
          "preemptions", "resumes", "spec_disables", "legacy_fallbacks",
          "recoveries", "retraces_after_warmup")


def _both(fn):
    return both(fn, **KW)


@pytest.fixture(scope="module")
def reference():
    """Fault-free greedy outputs of the port (held equal to JAX's in
    TestDisarmedBitExact)."""
    return port(**KW).engine().generate(PROMPTS, max_new_tokens=NEW)


def _assert_no_loss(reqs, pool=None):
    for r in reqs:
        assert r.state == "done", (r.request_id, r.state)
        assert r.finish_reason in ("eos", "length", "fault")
        if r.finish_reason == "fault":
            assert r.fault_info is not None and not r.fault_info.recovered
    if pool is not None:
        assert pool.available_count == pool.num_pages


def _ladder(sd):
    st = sd.stats()
    return {k: st[k] for k in LADDER}


def _outcome(reqs):
    return ([list(r.generated_ids) for r in reqs],
            [r.finish_reason for r in reqs],
            [fault_dict(r.fault_info) for r in reqs])


class TestFaultPlan:
    def test_parse_grammar(self):
        FaultPlan = port().R.FaultPlan
        p = FaultPlan.parse("step@3,7-9;poison@55;slow_ms=2.5;pool@1")
        assert p.schedule == {"step": frozenset({3, 7, 8, 9}),
                              "pool": frozenset({1})}
        assert (p.poison_token, p.slow_ms) == (55, 2.5)
        assert FaultPlan.parse("") is None and FaultPlan.parse("  ") is None
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultPlan.parse("bogus@1")
        with pytest.raises(ValueError, match="1-based"):
            FaultPlan({"step": [0]})
        with pytest.raises(ValueError, match="site@occurrences"):
            FaultPlan.parse("step")

    def test_sites_and_seeded_plans_match_jax(self):
        from paddle_tpu.inference import resilience as JR
        from paddle_tpu_torch.inference import resilience as TR

        assert TR.FAULT_SITES == JR.FAULT_SITES
        args = (11, ("step", "pool", "nan_logits"), 0.08, 120)
        assert TR.FaultPlan.seeded(*args).schedule == \
            JR.FaultPlan.seeded(*args).schedule
        p = TR.FaultPlan.parse("step@2")
        assert [p.consult("step") for _ in range(3)] == \
            [False, True, False]
        assert p.consults("step") == 3

    def test_flag_arms_engine(self):
        sd = port(**KW)
        with sd.flags(fault_inject="step@1"):
            eng = sd.engine()
        assert eng._fault.schedule["step"] == frozenset({1})
        assert sd.engine()._fault is None


class TestErrorTaxonomy:
    def test_hierarchy_and_fields_match_jax(self):
        from paddle_tpu.inference import errors as JE
        from paddle_tpu_torch.inference import errors as TE

        assert TE.__all__ == JE.__all__
        for name in ("PoolExhausted", "StepFault", "DegradedMode"):
            assert issubclass(getattr(TE, name), TE.ServingError)
        assert issubclass(TE.InjectedFault, TE.StepFault)
        assert issubclass(TE.HungStep, TE.StepFault)
        assert issubclass(TE.ServingError, RuntimeError)
        e = TE.StepFault("boom", site="verify", attempts=3, fatal=True)
        assert (e.site, e.attempts, e.fatal) == ("verify", 3, True)
        h = TE.HungStep("stall")
        assert (h.site, h.fatal) == ("hung", True)
        kw = dict(site="step", attempts=2, step=5, recovered=True,
                  message="m")
        assert TE.FaultInfo(**kw).as_dict() == JE.FaultInfo(**kw).as_dict()


class TestRetry:
    def test_transient_fault_retried_with_parity(self, reference):
        def scen(sd):
            eng = sd.engine(fault_plan="step@2")
            outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            _assert_no_loss([], eng.pool)
            return (outs, _ladder(sd), eng._resilience.backoff_ticks,
                    sd.obs.STEP_RETRIES.value(),
                    sd.obs.FAULTS_INJECTED.value(site="step"))

        j, t = _both(scen)
        assert j == t and t[0] == reference
        assert (t[1]["step_retries"], t[1]["faults_injected"]) == (1, 1)
        assert t[3:] == (1, 1)

    def test_backoff_ticks_capped_exponential(self):
        def scen(sd):
            with sd.flags(step_retries=6):
                eng = sd.engine(fault_plan="step@2-7")
                outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            return outs, eng._resilience.backoff_ticks

        j, t = _both(scen)
        assert j == t and t[1] == 31  # 1, 2, 4, 8, 8, 8


class TestNaNQuarantine:
    def test_only_offending_slot_dies(self, reference):
        def scen(sd):
            eng = sd.engine(fault_plan="nan_logits@3")
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng.run()
            _assert_no_loss(reqs, eng.pool)
            return _outcome(reqs), _ladder(sd)

        j, t = _both(scen)
        assert j == t
        (outs, reasons, infos), _ = t
        assert sorted(reasons) == ["fault", "length"]
        i = reasons.index("length")
        assert outs[i] == reference[i]
        f = infos[reasons.index("fault")]
        assert (f["site"], f["recovered"]) == ("nan_logits", False)

    def test_nan_during_prefill_never_registers_pages(self):
        def scen(sd):
            eng = sd.engine(fault_plan="nan_logits@1")
            r = eng.add_request(PROMPTS[0], max_new_tokens=NEW)
            eng.run()
            _assert_no_loss([r], eng.pool)
            return r.finish_reason, r.output_ids, eng.pool.cached_count

        j, t = _both(scen)
        assert j == t == ("fault", [], 0)

    def test_nan_in_spec_verify_quarantines_slot(self, reference):
        def scen(sd):
            eng = sd.engine(spec_decode_k=3, fault_plan="nan_logits@3")
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng.run()
            _assert_no_loss(reqs, eng.pool)
            return _outcome(reqs)

        j, t = _both(scen)
        assert j == t
        i = t[1].index("length")
        assert t[0][i] == reference[i]


class TestBisectQuarantine:
    def test_poisoned_request_isolated(self, reference):
        def scen(sd):
            eng = sd.engine(fault_plan="poison@55")
            good = eng.add_request(PROMPTS[0], max_new_tokens=NEW)
            bad = eng.add_request([55] + PROMPTS[1], max_new_tokens=NEW)
            eng.run()
            _assert_no_loss([good, bad], eng.pool)
            spans = [s for s in sd.obs.spans() if s[1] == "quarantine"]
            assert spans and spans[-1][5]["request"] == bad.request_id
            return _outcome([good, bad]), _ladder(sd)

        j, t = _both(scen)
        assert j == t
        (outs, reasons, infos), lad = t
        assert reasons == ["length", "fault"] and outs[0] == reference[0]
        assert infos[1]["attempts"] > 0
        assert lad["preemptions"] >= 1 and lad["step_retries"] >= 1

    def test_poison_arriving_late_still_isolated(self, reference):
        def scen(sd):
            eng = sd.engine(fault_plan="poison@55")
            good = eng.add_request(PROMPTS[0], max_new_tokens=NEW)
            for _ in range(4):
                eng.step()
            bad = eng.add_request([55, 3, 1], max_new_tokens=NEW)
            eng.run()
            _assert_no_loss([good, bad], eng.pool)
            return _outcome([good, bad]), _ladder(sd)

        j, t = _both(scen)
        assert j == t and t[0][1] == ["length", "fault"]
        assert t[0][0][0] == reference[0]


class TestPoolExhaustion:
    @pytest.mark.parametrize("plan", ["pool@1-2", "pool@3-4"])
    def test_exhaustion_contained(self, plan, reference):
        """pool@1-2 hits admission (backpressure: the request stays
        queued), pool@3-4 the step's block-table growth (the ladder
        retries)."""
        def scen(sd):
            eng = sd.engine(fault_plan=plan)
            outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            _assert_no_loss([], eng.pool)
            return outs, _ladder(sd)

        j, t = _both(scen)
        assert j == t and t[0] == reference
        assert t[1]["finished_fault"] == 0

    def test_unwound_admission_leaves_pool_consistent(self):
        def scen(sd):
            eng = sd.engine(fault_plan="pool@1")
            r = eng.add_request(PROMPTS[0], max_new_tokens=NEW)
            eng.step()
            state = r.state
            eng.pool.assert_consistent(
                live_pages=[p for q in eng._by_slot if q is not None
                            for p in q.pages])
            eng.run()
            return state, r.finish_reason, sd.stats()["resumes"]

        j, t = _both(scen)
        assert j == t and t[1:] == ("length", 0)


class TestDegradation:
    def test_drafter_faults_disable_spec_then_probe(self, reference):
        def scen(sd):
            with sd.flags(degraded_probe_steps=6):
                eng = sd.engine(spec_decode_k=3, fault_plan="drafter@1-3")
                outs = eng.generate(PROMPTS, max_new_tokens=NEW)
                lad = _ladder(sd)
                outs2 = eng.generate(PROMPTS, max_new_tokens=NEW)
            mode = sd.obs.DEGRADED_MODE.value(engine=eng._engine_id,
                                              mode="spec_off")
            return outs, outs2, lad, eng._resilience.spec_disabled, mode

        j, t = _both(scen)
        assert j == t
        assert t[0] == t[1] == reference
        assert t[2]["spec_disables"] == 1 and t[3:] == (False, 0)

    def test_stateful_drafter_stays_degraded(self):
        def scen(sd):
            if sd.jax:
                from paddle_tpu.inference.speculative import \
                    PromptLookupDrafter
            else:
                from paddle_tpu_torch.inference.speculative import \
                    PromptLookupDrafter

            class StatefulLookup(PromptLookupDrafter):
                stateful = True

            eng = sd.engine(spec_decode_k=3, drafter=StatefulLookup(),
                            fault_plan="drafter@1-3")
            eng.generate(PROMPTS, max_new_tokens=NEW)
            outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            return outs, eng._resilience.spec_disabled

        j, t = _both(scen)
        assert j == t and t[1] is True

    def test_draft_model_drafter_is_stateful(self):
        from paddle_tpu_torch.inference.speculative import (
            DraftModelDrafter, PromptLookupDrafter)

        assert DraftModelDrafter.stateful and \
            not PromptLookupDrafter.stateful

    def test_mixed_faults_fall_back_to_legacy_prefill(self, reference):
        def scen(sd):
            with sd.flags(degraded_probe_steps=6):
                eng = sd.engine(fault_plan="mixed_step@1-9")
                outs = eng.generate(PROMPTS, max_new_tokens=NEW)
                st = sd.stats()
                lad = (st["legacy_fallbacks"], st["prefill_compiles"] >= 1,
                       st["finished_fault"], st["step_retries"])
                outs2 = eng.generate(PROMPTS, max_new_tokens=NEW)
            return (outs, outs2, lad, eng._chunked, eng._prefix_cache,
                    eng._resilience.legacy_mode)

        j, t = _both(scen)
        assert j == t
        assert t[0] == t[1] == reference
        assert t[2][:3] == (1, True, 0) and t[3:] == (True, True, False)

    def test_verify_faults_degrade_spec(self, reference):
        def scen(sd):
            eng = sd.engine(spec_decode_k=3, fault_plan="verify@1-9")
            outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            return outs, _ladder(sd)

        j, t = _both(scen)
        assert j == t and t[0] == reference
        assert t[1]["spec_disables"] >= 1 and t[1]["step_retries"] >= 1


class TestRecovery:
    def test_snapshot_captures_inflight_state(self):
        sd = port(**KW)
        eng = sd.engine()
        r1 = eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        r2 = eng.add_request(PROMPTS[1], max_new_tokens=NEW)
        for _ in range(6):
            eng.step()
        snap = sd.R.EngineSnapshot(eng)
        assert len(snap) == 2 and snap.step_no == eng._step_no
        assert snap.rng is None  # greedy: no generator state carried
        rec = {id(x.request): x for x in snap.records}
        assert rec[id(r1)].output_ids == list(r1.output_ids)
        assert rec[id(r2)].max_new == NEW

    @pytest.mark.parametrize("handoff", [True, False])
    def test_recovery_is_greedy_bit_identical(self, handoff, reference):
        def scen(sd):
            eng = sd.engine(fault_plan="step@4-10")
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            fault = None
            while fault is None:
                try:
                    eng.step()
                except sd.E.StepFault as e:
                    fault = e
            new = sd.R.recover(eng, fault=fault, handoff=handoff)
            new.run()
            _assert_no_loss(reqs, new.pool)
            assert any(s[1] == "recovery" for s in sd.obs.spans())
            return (_outcome(reqs), _ladder(sd), new._step_no,
                    sd.stats()["exec_handoffs"] > 0)

        j, t = _both(scen)
        assert j == t
        assert t[0][0] == reference and t[1]["recoveries"] == 1
        assert all(f["recovered"] for f in t[0][2])
        assert t[3] is handoff

    def test_recovery_rides_prefix_cache(self):
        shared = [3, 1, 4, 1, 5, 9, 2, 6] * 3
        prompts = [shared + [11], shared + [12]]

        def scen(sd):
            ref = sd.engine(max_batch_size=1).generate(prompts,
                                                       max_new_tokens=8)
            sd.reset()
            eng = sd.engine(max_batch_size=1, fault_plan="step@6-9")
            reqs = [eng.add_request(p, max_new_tokens=8) for p in prompts]
            eng2, n = sd.R.serve_with_recovery(eng, max_recoveries=8)
            assert [list(r.generated_ids) for r in reqs] == ref
            return ref, n, sd.stats()["prefix_hits"]

        j, t = _both(scen)
        assert j == t and t[1] >= 1 and t[2] >= 1

    def test_recovery_budget_exhausts_to_degraded_mode(self):
        sd = port(**KW)
        eng = sd.engine(fault_plan="step@2-500")
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        with pytest.raises(sd.E.DegradedMode, match="recovery budget"):
            sd.R.serve_with_recovery(eng, max_recoveries=1)

    def test_recovery_releases_dead_engine(self):
        sd = port(**KW)
        eng = sd.engine()
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        for _ in range(5):
            eng.step()
        new = sd.R.recover(eng)
        assert new._step_no == eng._step_no and new.pool is not eng.pool
        # the dead engine holds no pool, weights or step any more
        assert eng._k_pages is None and eng._params is None
        assert not eng._trackers()
        new.run()

    def test_handoff_allocates_nothing(self, monkeypatch):
        """`recover(handoff=True)` builds the successor over the dead
        engine's weights, pools, scales, generator and graphs, zeroed,
        without allocating or quantizing its own."""
        sd = port(**KW)
        kw = dict(kv_quant="int8", serve_weights="int8")
        want = sd.engine(**kw).generate(PROMPTS, max_new_tokens=NEW)
        eng = sd.engine(**kw)
        reqs = [eng.add_request(p, max_new_tokens=NEW) for p in PROMPTS]
        for _ in range(5):
            eng.step()
        held = {a: getattr(eng, a) for a in eng._DEVICE_ATTRS}
        graphs = set(map(id, eng._trackers()))
        mats = eng.decode_stats()["weight_quant_mats"]

        def refused(*a, **k):
            raise AssertionError("the handoff allocated")

        monkeypatch.setattr(sd.S, "_tree_to", refused)
        monkeypatch.setattr(sd.S, "_quantize_gpt_params", refused)
        new = sd.R.recover(eng, handoff=True)
        monkeypatch.undo()
        assert all(getattr(new, a) is t for a, t in held.items())
        assert set(map(id, new._trackers())) == graphs
        assert not any(t.any() for t in (new._k_pages, new._v_pages,
                                         new._k_scales, new._v_scales))
        assert new.decode_stats()["weight_quant_mats"] == mats
        assert eng._k_pages is None and not eng._trackers()
        new.run()
        assert [r.generated_ids for r in reqs] == want

    def test_recovery_with_spec_engine(self, reference):
        def scen(sd):
            eng = sd.engine(spec_decode_k=3, fault_plan="step@4-16")
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng2, n = sd.R.serve_with_recovery(eng, max_recoveries=8)
            _assert_no_loss(reqs, eng2.pool)
            return _outcome(reqs), n, _ladder(sd)

        j, t = _both(scen)
        assert j == t and t[0][0] == reference and t[1] >= 1


class TestFrontendRecovery:
    def test_streams_survive_engine_rebuild(self, reference):
        def scen(sd):
            async def go():
                eng = sd.engine(fault_plan="step@3-9")
                async with sd.F.ServingFrontend(
                        eng, step_in_thread=False) as fe:
                    s1 = await fe.submit(PROMPTS[0], max_new_tokens=NEW)
                    s2 = await fe.submit(PROMPTS[1], max_new_tokens=NEW)
                    t1, t2 = await s1.collect(), await s2.collect()
                return fe._recoveries, [t1, t2], [
                    (s.finish_reason, fault_dict(s.fault_info))
                    for s in (s1, s2)]

            return run(go())

        j, t = _both(scen)
        assert j == t and t[0] >= 1 and t[1] == reference
        assert t[2][0][0] == "length" and t[2][0][1]["recovered"]

    def test_dead_driver_surfaces_structured_fault(self):
        def scen(sd):
            async def go():
                eng = sd.engine(fault_plan="step@3-500")
                fe = sd.F.ServingFrontend(eng, step_in_thread=False,
                                          max_recoveries=1)
                await fe.start()
                s = await fe.submit(PROMPTS[0], max_new_tokens=NEW)
                toks = await s.collect()
                err = None
                try:
                    await fe.close(drain=False)
                except sd.E.StepFault as e:
                    err = e
                return s, toks, err

            s, toks, err = run(go())
            assert isinstance(err, sd.E.StepFault) and err.fatal
            return (s.finish_reason, s.fault_info.recovered, toks,
                    s.fault_info.site)

        j, t = _both(scen)
        assert j == t and t[:2] == ("fault", False)

    def test_host_callback_fault_contained(self, reference):
        def scen(sd):
            got = []
            eng = sd.engine(fault_plan="host_callback@3")
            r = eng.add_request(PROMPTS[0], max_new_tokens=NEW,
                                on_token=got.append)
            eng.add_request(PROMPTS[1], max_new_tokens=NEW)
            eng.run()
            return r.generated_ids, got, fault_dict(r.fault_info)

        j, t = _both(scen)
        assert j == t and t[0] == reference[0] and len(t[1]) < NEW
        assert (t[2]["site"], t[2]["recovered"]) == ("host_callback", True)


class TestNoRequestLost:
    SITE_PLANS = {
        "step": "step@2",
        "mixed_step": "mixed_step@1-9",
        "decode_step": "decode_step@5-6",
        "pool": "pool@1-3",
        "nan_logits": "nan_logits@2",
        "slow_step": "slow_step@2;slow_ms=0.5",
        "host_callback": "host_callback@2",
        "poison": "poison@55",
    }

    @pytest.mark.parametrize("site", sorted(SITE_PLANS))
    def test_single_site_no_loss(self, site):
        def scen(sd):
            eng = sd.engine(fault_plan=self.SITE_PLANS[site])
            prompts = list(PROMPTS) + [[55, 2, 4]]
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in prompts]
            eng2, n = sd.R.serve_with_recovery(eng)
            _assert_no_loss(reqs, eng2.pool)
            return _outcome(reqs), n, _ladder(sd)

        j, t = _both(scen)
        assert j == t

    @pytest.mark.parametrize("site", ["drafter", "verify"])
    def test_spec_sites_no_loss(self, site):
        def scen(sd):
            eng = sd.engine(spec_decode_k=3, fault_plan=f"{site}@1-8")
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng2, n = sd.R.serve_with_recovery(eng)
            _assert_no_loss(reqs, eng2.pool)
            return _outcome(reqs), n, _ladder(sd)

        j, t = _both(scen)
        assert j == t

    def test_combined_storm_no_loss(self):
        plan = ("step@3;mixed_step@5;decode_step@9;pool@2,6;nan_logits@4;"
                "slow_step@7;host_callback@3;poison@55;slow_ms=0.5")

        def scen(sd):
            eng = sd.engine(fault_plan=sd.R.FaultPlan.parse(plan))
            prompts = list(PROMPTS) + [[55, 2, 4], [9, 9, 1, 1, 2]]
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in prompts]
            eng2, n = sd.R.serve_with_recovery(eng)
            _assert_no_loss(reqs, eng2.pool)
            return _outcome(reqs), n, _ladder(sd)

        j, t = _both(scen)
        assert j == t and t[2]["faults_injected"] >= 5


class TestCardContainment:
    """On the card the ladder contains only the faults the plan injects
    (``contain_foreign`` is False there): a step's or a drafter's own
    exception leaves `step` unretried, where the CPU keeps JAX's rule and
    contains it.  Rehearsed here by giving a CPU engine the card's
    rule."""

    def _engine(self, sd, card, **kw):
        eng = sd.engine(**kw)
        assert eng._resilience.contain_foreign  # JAX's rule on the CPU
        eng._resilience.contain_foreign = not card
        return eng

    @pytest.mark.parametrize("card", [False, True])
    def test_foreign_step_error(self, card):
        sd = port(**KW)
        eng = self._engine(sd, card)
        reqs = [eng.add_request(p, max_new_tokens=NEW) for p in PROMPTS]
        eng.step()
        inner, calls = eng._step_inner, {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("launch failed")
            return inner()

        eng._step_inner = flaky
        if card:
            with pytest.raises(RuntimeError, match="launch failed"):
                eng.step()
            assert calls["n"] == 1 and not eng._resilience.contained
        else:
            eng.step()
            assert eng._resilience.contained == {("RuntimeError", False): 2}
        assert sd.stats()["step_retries"] == (0 if card else 2)
        eng._step_inner = inner  # the engine itself is intact
        eng.run()
        assert [r.finish_reason for r in reqs] == ["length"] * 2

    @pytest.mark.parametrize("card", [False, True])
    def test_foreign_drafter_error(self, card):
        sd = port(**KW)
        eng = self._engine(sd, card, spec_decode_k=3)
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=NEW)

        def propose(caps):
            raise RuntimeError("draft launch failed")

        eng._spec.drafter.propose = propose
        if card:
            with pytest.raises(RuntimeError, match="draft launch failed"):
                eng.run()
            assert not eng._resilience.contained
        else:
            eng.run()
            assert set(eng._resilience.contained) == {
                ("RuntimeError", False)}
            assert sd.stats()["spec_disables"] >= 1

    def test_injected_faults_contained_alike(self):
        """Every fault of a plan is contained under either rule, with
        the same outcome; the plan's ``fired`` counts add up to
        ``faults_injected``."""
        plan = "step@3,7;pool@2;host_callback@5;mixed_step@4-6;poison@55"
        prompts = list(PROMPTS) + [[55, 2, 4]]
        outs = []
        for card in (False, True):
            sd = port(**KW)
            eng = self._engine(sd, card, fault_plan=plan)
            reqs = [eng.add_request(p, max_new_tokens=NEW,
                                    on_token=lambda t: None)
                    for p in prompts]
            eng.run()
            _assert_no_loss(reqs, eng.pool)
            fired, sched = eng._fault.fired, eng._fault.schedule
            assert sum(fired.values()) == sd.stats()["faults_injected"]
            assert fired["poison"] >= 1 and fired["step"] == 2
            assert all(fired.get(s, 0) <= len(o) for s, o in sched.items())
            assert eng._resilience.contained and \
                all(inj for _, inj in eng._resilience.contained)
            outs.append((_outcome(reqs), _ladder(sd), dict(fired),
                         dict(eng._resilience.contained)))
        assert outs[0] == outs[1]
        assert outs[1][0][1][2] == "fault"


class TestEngineRelease:
    """An engine is freed by reference counting the moment its last
    reference goes: its scheduler, ladder, journal, watchdog, speculative
    decoder, drafter and requests hold it weakly, and the ladder keeps no
    exception (a traceback holds the engine's frames).  So its pools and,
    on the card, its CUDA graphs never wait for the cyclic collector,
    which could run inside a later engine's capture or serve."""

    CASES = {
        "plain": {},
        "slo": dict(scheduler="slo"),
        "draft_model": dict(spec_decode_k=2, draft=True),
        # a budget no step of a loaded CPU reaches: the watchdog is
        # armed, never fired
        "journal_watchdog": dict(journal=True, step_timeout_ms=600000.0),
        "faults": dict(fault_plan="step@3;pool@2;host_callback@2;"
                                  "mixed_step@2-4;poison@55"),
        "drafter_faults": dict(spec_decode_k=2, fault_plan="drafter@1-4"),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_freed_without_the_collector(self, case, tmp_path):
        import gc
        import weakref

        from paddle_tpu_torch.inference.speculative import \
            DraftModelDrafter

        sd = port(**KW)
        kw = dict(self.CASES[case])
        if kw.pop("draft", False):
            kw["drafter"] = DraftModelDrafter(sd.model)
        if kw.pop("journal", False):
            kw["journal_dir"] = str(tmp_path / "j")
        gc.collect()
        gc.disable()
        try:
            eng = sd.engine(**kw)
            # a short serve: release does not depend on its length
            reqs = [eng.add_request(p, max_new_tokens=6,
                                    on_token=lambda t: None)
                    for p in list(PROMPTS) + [[55, 2, 4]]]
            eng.step()
            dead = weakref.ref(eng)
            eng = sd.R.recover(eng, handoff=case != "plain")
            assert dead() is None  # the rebuilt engine's donor
            eng.run()
            _assert_no_loss(reqs, eng.pool)
            ref = weakref.ref(eng)
            del eng
            assert ref() is None  # the requests do not pin it
        finally:
            gc.enable()


class TestRetriedInt8Pools:
    """A step that raises after its KV write is retried over the same
    rows: in place here, where JAX's failed executable leaves its input
    buffers untouched.  The int8 write folds the same absmax into an
    unchanged scale and requantizes the same bytes, so the retried
    engine's pools equal a clean engine's bit for bit."""

    def _pools(self, eng):
        # the last page is the drop page, where rows JAX drops land in
        # no defined order: not part of the pool's contents
        return [t[:, :, :-1].clone() for t in (
            eng._k_pages, eng._v_pages, eng._k_scales, eng._v_scales)]

    def test_retry_after_the_write_is_idempotent(self):
        sd = port(**KW)
        kw = dict(kv_quant="int8", serve_weights="int8")
        clean = sd.engine(**kw)
        faulty = sd.engine(fault_plan="host_callback@2", **kw)
        fired = {"n": 0}
        orig_fetch = faulty._fetch

        def fetch(out):
            # the step ran (its K/V rows are written); then it fails
            fired["n"] += 1
            if fired["n"] in (3, 6):
                raise RuntimeError("device fault after the KV write")
            return orig_fetch(out)

        faulty._fetch = fetch
        got = []
        reqs = []
        for eng in (clean, faulty):
            reqs.append([eng.add_request(p, max_new_tokens=NEW,
                                         on_token=got.append)
                         for p in PROMPTS])
        for _ in range(8):
            clean.step()
            faulty.step()
            for a, b in zip(self._pools(clean), self._pools(faulty)):
                assert torch.equal(a, b)
        st = sd.stats()
        assert st["step_retries"] == 2
        clean.run()
        faulty.run()
        assert [r.generated_ids for r in reqs[0]] == \
            [r.generated_ids for r in reqs[1]]
        assert [r.fault_info.site for r in reqs[1] if r.fault_info] == \
            ["host_callback"]


class TestDisarmedBitExact:
    def test_off_is_bit_exact_with_zero_retraces(self, reference):
        def scen(sd):
            eng = sd.engine()
            assert eng._fault is None
            outs = eng.generate(PROMPTS, max_new_tokens=NEW)
            st = sd.stats()
            assert all(st[k] == 0 for k in LADDER), _ladder(sd)
            return outs

        j, t = _both(scen)
        assert j == t == reference

    def test_off_spec_and_slo_paths_bit_exact(self, reference):
        def scen(sd):
            return [sd.engine(**kw).generate(PROMPTS, max_new_tokens=NEW)
                    for kw in (dict(spec_decode_k=3),
                               dict(scheduler="slo"),
                               dict(ragged_step=True),
                               dict(kv_quant="int8"))]

        j, t = _both(scen)
        assert j == t
        assert t[0] == t[1] == t[2] == reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    def test_retries_replay_captured_graphs(self, cuda_device):
        """Retries replay the captured graphs: no new compile, no
        retrace, the clean tokens."""
        from paddle_tpu_torch.inference import serving as TS
        from paddle_tpu_torch.models.gpt import GPT, GPTConfig

        # head_dim 64, a width K1 takes
        model = GPT.random(GPTConfig(vocab_size=512, hidden_size=128,
                                     num_layers=2, num_heads=2,
                                     max_seq_len=256), seed=0,
                           device=cuda_device)
        sd = port(**KW)
        ref = TS.DecodeEngine(model, **KW).generate(PROMPTS,
                                                    max_new_tokens=NEW)
        sd.reset()
        eng = TS.DecodeEngine(model, fault_plan="step@3,7;mixed_step@2",
                              **KW)
        outs = eng.generate(PROMPTS, max_new_tokens=NEW)
        st = sd.stats()
        assert outs == ref
        assert st["step_retries"] == st["faults_injected"] >= 2
        # the card's rule: the ladder took the injected faults alone
        assert not eng._resilience.contain_foreign
        assert eng._resilience.contained == {
            ("InjectedFault", True): st["faults_injected"]}
        assert st["retraces_after_warmup"] == 0
        assert eng.graph_captures() == st["mixed_compiles"] + \
            st["decode_compiles"]
