"""The port's durable serving (`paddle_tpu_torch.inference.durability`)
against the JAX package's: write-ahead journal, snapshots, fresh-engine
restore, compaction, graph handoff and the hung-step watchdog.

The scenarios are tests/test_durability.py's, at its tiny config: each
runs on the JAX engine and on the port's engine (``device="cpu"``) over
the same weights and request ids, and the greedy tokens, the streamed
logs across both lives, the journal's records and the counters must
agree.  The port's own concerns are held here too: equal
`config_fingerprint` digests across the packages, zeroed pools on a
graph handoff, the sampling generator's state carried by the snapshot
(sampled restores checked at distribution level), int8 sidecar pages
restored bit-equal, and an abandoned engine's late step launching
nothing.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json
import os
import pickle

import numpy as np
import pytest
import torch
from scipy import stats as sstats

from torch_reliability_common import both, models, port, run

KW = dict(max_batch_size=2, max_seq_len=96, page_size=4)
PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2],
           [7, 8, 9, 7, 8, 9, 7, 8]]
NEW = 16


def _both(fn):
    return both(fn, **KW)


@pytest.fixture(scope="module")
def reference():
    return port(**KW).engine().generate(PROMPTS, max_new_tokens=NEW)


def _streamed_serve(eng, prompts=PROMPTS, max_new=NEW):
    streamed = {}
    reqs = []
    for p in prompts:
        req = eng.add_request(p, max_new_tokens=max_new)
        req.on_token = (lambda rid: lambda t: streamed.setdefault(
            rid, []).append(t))(req.request_id)
        reqs.append(req)
    return reqs, streamed


def _rewire(rmap, streamed):
    for rid, req in rmap.items():
        req.on_token = (lambda r: lambda t: streamed.setdefault(
            r, []).append(t))(rid)


def _records(sd, d):
    """The journal's records, the cfg record reduced to its fingerprint
    (the config dicts are compared in test_torch_journal_interop)."""
    events, _ = sd.D.read_journal(os.path.join(d, "journal.wal"))
    return [{"t": "cfg", "fp": e["fp"]} if e["t"] == "cfg" else e
            for e in events]


def _snapshot_obj(sd, d):
    wire = sd.D.load_snapshot(d)
    if wire is None:
        return None
    obj = wire.to_obj()
    obj.pop("engine_id")
    obj.pop("cost", None)  # the JAX cost model's calibration
    if obj.get("kv"):
        obj["kv"].pop("crc")  # npz bytes carry a zip timestamp
        obj["kv"].pop("bytes")
    return obj


class TestWireForms:
    def test_request_wire_round_trip_equality(self):
        sd = port(**KW)
        eng = sd.engine()
        r = eng.add_request(PROMPTS[0], max_new_tokens=NEW,
                            deadline_ms=5000.0, slo_ttft_ms=100.0)
        for _ in range(5):
            eng.step()
        w = sd.D.RequestWire.from_request(r)
        assert sd.D.RequestWire.from_obj(
            json.loads(json.dumps(w.to_obj()))) == w
        assert w.generated == list(r.generated_ids)
        assert w.prompt == PROMPTS[0]

    def test_materialize_folds_replay(self):
        sd = port()
        req = sd.D.RequestWire(request_id=42, prompt=[1, 2, 3],
                               generated=[9, 8], max_new=10, streamed=4,
                               eos=None, priority=0).materialize()
        assert req.prompt_ids == [1, 2, 3, 9, 8]
        assert (req.max_new_tokens, req.orig_prompt_len, req._absorbed,
                req._emit_gate, req.request_id) == (8, 3, 2, 2, 42)
        assert list(req.generated_ids) == [9, 8]

    @pytest.mark.parametrize("sampler", ["greedy", "top_k"])
    def test_snapshot_wire_round_trip_and_picklable(self, sampler):
        sd = port(**KW)
        eng = sd.engine(sampler=sampler, top_k=8, seed=3)
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=NEW)
        for _ in range(6):
            eng.step()
        wire = sd.R.EngineSnapshot(eng).to_wire(journal_pos=7)
        assert (wire.journal_pos, wire.step_no) == (7, eng._step_no)
        assert len(wire.records) == 2
        back = sd.D.SnapshotWire.from_obj(json.loads(json.dumps(
            wire.to_obj())))
        assert back == wire
        pickle.loads(pickle.dumps(wire))
        if sampler == "greedy":
            assert wire.rng is None and "rng" not in wire.to_obj()
        else:
            # the generator's state: a restore continues its stream
            state = eng._generator.get_state()
            assert bytes.fromhex(wire.rng) == bytes(state.numpy())


class TestJournal:
    def test_records_equal_jax(self, tmp_path):
        def scen(sd):
            d = str(tmp_path / sd.name)
            eng = sd.engine(journal_dir=d)
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng.run()
            recs = _records(sd, d)
            kinds = [e["t"] for e in recs]
            assert kinds[0] == "cfg" and kinds.count("a") == 2
            assert kinds.count("f") == 2 and kinds.count("e") > 0
            marks = {e["id"]: e["n"] for e in recs if e["t"] == "e"}
            for r in reqs:
                assert marks[r.request_id] == len(r.generated_ids)
            assert sd.stats()["journal_records"] == len(recs)
            return recs

        j, t = _both(scen)
        assert j == t

    def test_fsync_policy_validated(self, tmp_path):
        sd = port(**KW)
        with pytest.raises(ValueError, match="journal_fsync"):
            sd.D.DurabilityManager(sd.engine(), str(tmp_path / "x"),
                                   fsync="bogus")

    def test_reopen_truncates_torn_tail(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d)
        eng.add_request(PROMPTS[0], max_new_tokens=4)
        eng.run()
        path = os.path.join(d, "journal.wal")
        n_clean, _ = sd.D.read_journal(path)
        with open(path, "ab") as f:
            f.write(b"deadbeef {torn json garbage")
        eng2 = sd.engine(journal_dir=d)
        eng2.add_request(PROMPTS[1], max_new_tokens=4)
        eng2.run()
        events, _ = sd.D.read_journal(path)
        assert len(events) > len(n_clean)
        assert all("t" in e for e in events)


class TestSnapshots:
    def test_periodic_snapshot_equals_jax(self, tmp_path):
        def scen(sd):
            d = str(tmp_path / sd.name)
            with sd.flags(snapshot_interval_steps=4):
                eng = sd.engine(journal_dir=d)
                for p in PROMPTS:
                    eng.add_request(p, max_new_tokens=NEW)
                for _ in range(9):
                    eng.step()
            eng._durability.flush()
            assert sd.stats()["journal_snapshots"] >= 1
            return _snapshot_obj(sd, d)

        j, t = _both(scen)
        assert j == t and t["journal_pos"] > 0 and t["kv"]["hashes"]

    def test_torn_snapshot_falls_back_to_journal(self, tmp_path):
        def scen(sd):
            d = str(tmp_path / sd.name)
            with sd.flags(snapshot_interval_steps=3):
                eng = sd.engine(journal_dir=d)
                reqs, streamed = _streamed_serve(eng)
                for _ in range(8):
                    eng.step()
            eng._durability.flush()
            snap_path = os.path.join(d, "snapshot.json")
            data = bytearray(open(snap_path, "rb").read())
            data[len(data) // 2] ^= 0xFF
            open(snap_path, "wb").write(bytes(data))
            assert sd.D.load_snapshot(d) is None
            eng2, rmap = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            _rewire(rmap, streamed)
            eng2.run()
            order = sorted(rmap)
            return ([list(rmap[r].generated_ids) for r in order],
                    [streamed[r] for r in order])

        j, t = _both(scen)
        assert j == t and t[0] == t[1]


def _dev(sd):
    return {} if sd.jax else {"device": "cpu"}


class TestRestore:
    def test_restore_bit_identical_no_reemission(self, tmp_path,
                                                 reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            with sd.flags(snapshot_interval_steps=4):
                eng = sd.engine(journal_dir=d)
                reqs, streamed = _streamed_serve(eng)
                for _ in range(9):
                    eng.step()
            eng._durability.flush()
            pre = {rid: len(v) for rid, v in streamed.items()}
            assert any(pre.values())
            eng2, rmap = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            assert sorted(rmap) == sorted(r.request_id for r in reqs)
            infos = [(q.fault_info.site, q.fault_info.recovered)
                     for q in rmap.values()]
            _rewire(rmap, streamed)
            eng2.run()
            order = sorted(rmap)
            assert any(s[1] == "restore" for s in sd.obs.spans())
            return ([list(rmap[r].generated_ids) for r in order],
                    [streamed[r] for r in order],
                    [rmap[r].finish_reason for r in order], infos, pre,
                    sd.stats()["restores"])

        j, t = _both(scen)
        assert j == t
        assert t[0] == t[1] == reference
        assert t[3] == [("restore", True)] * 2 and t[5] == 1

    def test_truncated_tail_record_restores_last_consistent(
            self, tmp_path, reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            eng = sd.engine(journal_dir=d)
            for p in PROMPTS:
                eng.add_request(p, max_new_tokens=NEW)
            for _ in range(8):
                eng.step()
            eng._durability.flush()
            path = os.path.join(d, "journal.wal")
            raw = open(path, "rb").read()
            open(path, "wb").write(raw[:-7])
            marks = {}
            for e in sd.D.read_journal(path)[0]:
                if e["t"] == "e":
                    marks[e["id"]] = max(marks.get(e["id"], 0), e["n"])
            streamed = {}
            eng2, rmap = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            _rewire(rmap, streamed)
            eng2.run()
            order = sorted(rmap)
            for i, rid in enumerate(order):
                assert streamed[rid] == \
                    list(rmap[rid].generated_ids)[marks.get(rid, 0):]
            return [list(rmap[r].generated_ids) for r in order], marks

        j, t = _both(scen)
        assert j == t and t[0] == reference

    def test_finished_requests_never_readmitted(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d)
        eng.generate(PROMPTS, max_new_tokens=4)
        eng._durability.flush()
        eng2, rmap = sd.D.restore_from_dir(d, sd.model, device="cpu")
        assert rmap == {} and not eng2._queue

    def test_double_death_double_restore(self, tmp_path, reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            eng = sd.engine(journal_dir=d)
            reqs, streamed = _streamed_serve(eng)
            for _ in range(5):
                eng.step()
            eng._durability.flush()
            eng2, rmap = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            _rewire(rmap, streamed)
            for _ in range(5):
                eng2.step()
            eng2._durability.flush()
            eng3, rmap2 = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            _rewire(rmap2, streamed)
            eng3.run()
            order = sorted(r.request_id for r in reqs)
            final = {**rmap, **rmap2}
            return ([list(final[r].generated_ids) for r in order],
                    [streamed[r] for r in order], sd.stats()["restores"])

        j, t = _both(scen)
        assert j == t and t[0] == t[1] == reference and t[2] == 2

    def test_wrong_model_fingerprint_raises(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d)
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        for _ in range(3):
            eng.step()
        eng._durability.flush()
        with pytest.raises(ValueError, match="fingerprint"):
            sd.D.restore_from_dir(d, models(123)[1], device="cpu")

    def test_missing_journal_raises(self, tmp_path):
        sd = port(**KW)
        with pytest.raises(FileNotFoundError):
            sd.D.restore_from_dir(str(tmp_path / "nope"), sd.model,
                                  device="cpu")


class TestJournalCompaction:
    def _dead_serve(self, sd, d, steps=9):
        with sd.flags(snapshot_interval_steps=4):
            eng = sd.engine(journal_dir=d)
            reqs, streamed = _streamed_serve(eng)
            for _ in range(steps):
                eng.step()
        eng._durability.flush()
        return reqs, streamed

    def test_restore_compacts_with_size_assertion(self, tmp_path,
                                                  reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            reqs, streamed = self._dead_serve(sd, d)
            path = os.path.join(d, "journal.wal")
            before = (os.path.getsize(path),
                      len(sd.D.read_journal(path)[0]))
            eng2, rmap = sd.D.restore_from_dir(d, sd.model, **_dev(sd))
            recs_after = len(sd.D.read_journal(path)[0])
            assert os.path.getsize(path) < before[0]
            assert before[1] > 1 + 4 * len(rmap) >= recs_after
            compacted = _records(sd, d)
            _rewire(rmap, streamed)
            eng2.run()
            order = sorted(rmap)
            return (compacted, [streamed[r] for r in order],
                    sd.stats()["journal_compactions"])

        j, t = _both(scen)
        assert j == t and t[1] == reference and t[2] == 1

    def test_compacted_ids_keep_monotonic(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d)
        finished = eng.add_request(PROMPTS[0], max_new_tokens=2)
        live = eng.add_request(PROMPTS[1], max_new_tokens=NEW)
        while finished.state != "done":
            eng.step()
        eng._durability.flush()
        eng2, rmap = sd.D.restore_from_dir(d, sd.model, device="cpu")
        assert sorted(rmap) == [live.request_id]
        eng2._durability.flush()
        eng3, _ = sd.D.restore_from_dir(d, sd.model, device="cpu")
        fresh = eng3.add_request(PROMPTS[0], max_new_tokens=2)
        assert fresh.request_id > max(finished.request_id, live.request_id)

    def test_compact_flag_off_appends_only(self, tmp_path, reference):
        sd = port(**KW)
        d = str(tmp_path / "j")
        reqs, streamed = self._dead_serve(sd, d)
        path = os.path.join(d, "journal.wal")
        raw_before = open(path, "rb").read()
        eng2, rmap = sd.D.restore_from_dir(d, sd.model, compact=False,
                                           device="cpu")
        assert open(path, "rb").read()[:len(raw_before)] == raw_before
        assert sd.stats()["journal_compactions"] == 0
        _rewire(rmap, streamed)
        eng2.run()
        assert [list(rmap[r].generated_ids) for r in sorted(rmap)] == \
            reference

    def test_compact_journal_public_api(self, tmp_path):
        def scen(sd):
            d = str(tmp_path / sd.name)
            self._dead_serve(sd, d)
            st = sd.D.compact_journal(d)
            assert st["bytes_after"] < st["bytes_before"]
            assert st["bytes_after"] == os.path.getsize(
                os.path.join(d, "journal.wal"))
            # bytes differ by the cfg record, whose telemetry keys only
            # the JAX engine writes
            return (st["records_before"], st["records_after"],
                    _records(sd, d))

        j, t = _both(scen)
        assert j == t


class TestAdoption:
    """Fleet failover: a dead engine's journal replayed into a live
    survivor (`adopt_from_dir`), directly and through
    `ServingFrontend.adopt`."""

    def _dead(self, sd, d):
        eng = sd.engine(journal_dir=d)
        reqs, streamed = _streamed_serve(eng)
        for _ in range(6):
            eng.step()
        eng._durability.flush()
        return reqs, streamed

    def test_adopt_from_dir_into_a_live_engine(self, tmp_path, reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            reqs, streamed = self._dead(sd, d)
            survivor = sd.engine(journal_dir=str(tmp_path / (sd.name + "s")))
            delivered = {reqs[0].request_id: 1}
            rmap, meta = sd.D.adopt_from_dir(
                d, survivor, delivered=delivered,
                on_token_factory=lambda rid: (
                    lambda t: streamed.setdefault(rid, []).append(t)))
            survivor.run()
            order = sorted(rmap)
            return ([list(rmap[r].generated_ids) for r in order],
                    [{k: v for k, v in meta[r].items() if k != "request_id"}
                     for r in order],
                    [streamed[r] for r in order], sd.stats()["adoptions"])

        j, t = _both(scen)
        assert j == t and t[0] == reference and t[3] == 1
        # the consumer of request 0 got one token: the rest re-deliver
        assert t[1][0]["start_index"] == 1

    def test_frontend_adopt(self, tmp_path, reference):
        def scen(sd):
            d = str(tmp_path / sd.name)
            self._dead(sd, d)

            async def go():
                async with sd.F.ServingFrontend(sd.engine()) as fe:
                    out = await fe.adopt(d)
                    return {rid: (v["start_index"], v["backfill"],
                                  await v["stream"].collect())
                            for rid, v in sorted(out.items())}

            return run(go())

        j, t = _both(scen)
        assert j == t
        assert [b + s for _, b, s in t.values()] == [
            r[i:] for r, (i, _, _) in zip(reference, t.values())]


class TestKVSidecar:
    @pytest.mark.parametrize("kv_quant", ["off", "int8"])
    def test_installed_pages_bit_equal(self, tmp_path, kv_quant,
                                       reference):
        sd = port(**KW)
        d = str(tmp_path / "j")
        with sd.flags(snapshot_interval_steps=6):
            eng = sd.engine(journal_dir=d, kv_quant=kv_quant)
            reqs, streamed = _streamed_serve(eng)
            for _ in range(6):
                eng.step()
        eng._durability.flush()
        snap = sd.D.load_snapshot(d)
        dead = {h: p for p, h in eng.pool._page_hash.items()}
        assert snap.kv and snap.kv["dtype"] == (
            "int8" if kv_quant == "int8" else "float32")
        eng2, rmap = sd.D.restore_from_dir(d, sd.model, device="cpu")
        live = {h: p for p, h in eng2.pool._page_hash.items()}
        assert live and set(live) <= set(dead)
        names = ["_k_pages", "_v_pages"] + (
            ["_k_scales", "_v_scales"] if kv_quant == "int8" else [])
        for h, p in live.items():
            for name in names:
                assert torch.equal(getattr(eng2, name)[:, :, p],
                                   getattr(eng, name)[:, :, dead[h]])
        _rewire(rmap, streamed)
        eng2.run()
        if kv_quant == "off":
            order = sorted(rmap)
            assert [streamed[r] for r in order] == reference
        assert sd.stats()["prefix_hits"] >= 1


class TestFingerprint:
    @pytest.mark.parametrize("kw", [
        {}, dict(kv_quant="int8"), dict(serve_weights="int8"),
        dict(ragged_step=True), dict(spec_decode_k=3),
        dict(chunked_prefill=False), dict(sampler="top_k", top_k=5,
                                          temperature=0.7)])
    def test_config_fingerprint_equals_jax(self, kw):
        """Same weights and configuration: equal digests in both
        packages (JAX's dtype strings and key order), so a journal moves
        between them."""
        j, t = _both(lambda sd: sd.engine(**kw).config_fingerprint())
        assert j == t

    def test_fingerprint_tracks_config(self):
        sd = port(**KW)
        fps = {sd.engine(**kw).config_fingerprint() for kw in (
            {}, dict(page_size=8), dict(kv_quant="int8"),
            dict(ragged_step=True))}
        assert len(fps) == 4


class TestExecutableHandoff:
    def _fatal(self, sd, **kw):
        eng = sd.engine(fault_plan="step@6-12", **kw)
        reqs = [eng.add_request(p, max_new_tokens=NEW) for p in PROMPTS]
        while True:
            try:
                eng.step()
            except sd.E.StepFault as e:
                return eng, reqs, e

    @pytest.mark.parametrize("handoff", [True, False])
    def test_recovery_graphs(self, handoff, reference):
        def scen(sd):
            eng, reqs, fault = self._fatal(sd)
            before = sd.stats()
            new = sd.R.recover(eng, fault=fault, handoff=handoff)
            new.run()
            after = sd.stats()
            keys = ("mixed_compiles", "decode_compiles",
                    "prefill_compiles", "verify_compiles")
            return ([list(r.generated_ids) for r in reqs],
                    {k: after[k] - before[k] for k in keys},
                    after["exec_handoffs"] > 0,
                    after["retraces_after_warmup"])

        j, t = _both(scen)
        assert j == t and t[0] == reference
        assert t[2] is handoff and t[3] == 0
        if handoff:
            assert not any(t[1].values())  # recompiled nothing
        else:
            assert t[1]["mixed_compiles"] > 0

    def test_fingerprint_gates_handoff(self):
        sd = port(**KW)
        a = sd.engine()
        a.generate([PROMPTS[0]], max_new_tokens=4)
        assert sd.engine(page_size=8).adopt_executables(a) == 0
        matched = sd.engine()
        mixed = a._mixed_fn
        assert matched.adopt_executables(a) >= 1
        assert matched._mixed_fn is mixed
        # a used engine adopts nothing: its own graphs read its tensors
        assert sd.engine().adopt_executables(matched) >= 1
        assert matched.adopt_executables(sd.engine()) == 0

    def test_handoff_zeroes_the_pools(self):
        """The adopted pools start from zero, as the JAX engine's fresh
        pools do: stale pages must not reach masked attention."""
        sd = port(**KW)
        for kv in ("off", "int8"):
            a = sd.engine(kv_quant=kv)
            a.add_request(PROMPTS[0], max_new_tokens=NEW)
            for _ in range(4):
                a.step()
            pools = (a._k_pages, a._v_pages, a._k_scales, a._v_scales)
            assert a._k_pages.abs().sum() > 0
            b = sd.engine(kv_quant=kv)
            assert b.adopt_executables(a) >= 1
            for got, was in zip((b._k_pages, b._v_pages, b._k_scales,
                                 b._v_scales), pools):
                assert got is was
                assert got is None or not got.any()
            assert a._k_pages is None and not a._trackers()

    def test_spec_verify_hands_off(self):
        sd = port(**KW)
        eng = sd.engine(spec_decode_k=3)
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=NEW)
        for _ in range(4):
            eng.step()
        verify = eng._spec._verify_fn
        assert verify is not None
        new = sd.R.recover(eng, snapshot=sd.R.EngineSnapshot(eng))
        assert new._spec._verify_fn is verify
        new.run()


class TestWatchdog:
    @pytest.fixture(autouse=True)
    def _one_thread(self):
        """These scenarios time real steps against a budget: one
        intra-op thread keeps a tiny step from stretching past it while
        the suite's other workers load the CPU (a worker's default is a
        thread a core)."""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    def test_disarmed_by_default(self):
        eng = port(**KW).engine()
        assert eng._watchdog is None and eng._durability is None

    def test_compile_steps_exempt(self):
        eng = port(**KW).engine(step_timeout_ms=1000.0)
        wd = eng._watchdog
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        eng._admit()
        verdicts = []
        for _ in range(3):
            wd.arm()
            eng._resilience.run_step()
            verdicts.append(wd.classify(999.0))
        assert verdicts == [False, False, True]
        assert not wd.classify(1e-6)

    def test_posthoc_hang_recovers_with_parity(self, reference):
        def scen(sd):
            # a budget far above a loaded CPU's step (the suite runs six
            # workers) and a stall far above the budget
            eng = sd.engine(fault_plan="slow_step@6;slow_ms=5000",
                            step_timeout_ms=2000.0)
            reqs = [eng.add_request(p, max_new_tokens=NEW)
                    for p in PROMPTS]
            eng2, n = sd.R.serve_with_recovery(eng)
            st = sd.stats()
            seq = [s[1] for s in sd.obs.spans()
                   if s[1].startswith("health:")]
            states = {(x["labels"]["engine"], x["labels"]["state"]):
                      x["value"] for x in sd.obs.snapshot()[
                          "paddle_engine_health"]["series"]}
            assert not any(e == str(eng._engine_id) for e, _ in states)
            assert states[(str(eng2._engine_id), "live")] == 1
            return ([list(r.generated_ids) for r in reqs], n,
                    st["hung_steps"], st["recoveries"], seq)

        j, t = _both(scen)
        assert j == t and t[0] == reference
        assert t[1:5] == (1, 1, 1, ["health:hung", "health:recovering",
                                    "health:live"])

    def test_abandon_detaches_durability(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d, step_timeout_ms=500.0)
        eng.add_request(PROMPTS[0], max_new_tokens=4)
        eng.step()
        eng._abandon_inflight()
        assert eng._abandoned and eng._graph_memory.abandoned
        assert eng._durability is None and eng._watchdog is None
        eng.step()  # the late step touches neither file
        events, _ = sd.D.read_journal(os.path.join(d, "journal.wal"))
        assert events[0]["t"] == "cfg"

    def test_abandoned_engine_late_step_launches_nothing(self):
        """A worker that returns into an abandoned engine's step
        launches no step: every step graph refuses before it stages an
        input, and builds nothing new."""
        sd = port(**KW)
        eng = sd.engine(step_timeout_ms=500.0)
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        for _ in range(3):
            eng.step()
        fn = eng._decode_fn
        calls = []
        inner = fn.fn
        fn.fn = lambda *a: calls.append(1) or inner(*a)
        eng._abandon_inflight()
        before = sd.stats()
        with pytest.raises(sd.E.StepFault, match="abandoned"):
            fn(eng._bt, eng._lens, eng._last, eng._active)
        assert calls == []
        after = sd.stats()
        assert after["decode_compiles"] == before["decode_compiles"]
        assert sd.R.recover(eng).adopt_executables(eng) == 0

    def test_recover_retires_dead_journal_writer(self, tmp_path):
        sd = port(**KW)
        d = str(tmp_path / "j")
        eng = sd.engine(journal_dir=d, fault_plan="step@4-10")
        eng.add_request(PROMPTS[0], max_new_tokens=NEW)
        fault = None
        while fault is None:
            try:
                eng.step()
            except sd.E.StepFault as e:
                fault = e
        new = sd.R.recover(eng, fault=fault)
        assert eng._durability is None
        assert not new._durability._fh.closed
        new.run()
        events, _ = sd.D.read_journal(os.path.join(d, "journal.wal"))
        assert any(e["t"] == "f" for e in events)

    def test_frontend_abandons_hung_worker_streams_survive(self,
                                                           reference):
        def scen(sd):
            async def go():
                eng = sd.engine(fault_plan="slow_step@12;slow_ms=6000",
                                step_timeout_ms=2000.0)
                async with sd.F.ServingFrontend(eng) as fe:
                    warm = await fe.submit(PROMPTS[0], max_new_tokens=4)
                    await warm.collect()
                    s1 = await fe.submit(PROMPTS[0], max_new_tokens=NEW)
                    s2 = await fe.submit(PROMPTS[1], max_new_tokens=NEW)
                    t1, t2 = await s1.collect(), await s2.collect()
                return (fe._recoveries, [t1, t2],
                        [s1.finish_reason, s2.finish_reason], eng)

            n, toks, reasons, dead = run(go())
            # the abandoned worker's late return launched nothing: its
            # graph memory refuses and the engine holds no live slot
            assert dead._abandoned and not dead._active.any()
            if not sd.jax:
                assert dead._graph_memory.abandoned
            seq = [s[1] for s in sd.obs.spans()
                   if s[1].startswith("health:")]
            st = sd.stats()
            return n, toks, reasons, seq, st["recoveries"], st["hung_steps"]

        j, t = _both(scen)
        assert j == t and t[1] == reference
        assert t[0] == 1 and t[2] == ["length", "length"]
        assert t[3] == ["health:hung", "health:recovering", "health:live"]


class TestSampledRestore:
    def test_sampled_restore_matches_distribution(self, tmp_path):
        """Sampling across a restore: the snapshot carries the engine
        generator's state (not JAX's per-request fold counters), so a
        restored sampled serve loses no request, re-emits no token and
        draws from the same distribution as an uninterrupted serve: the
        generated-token histograms of both agree (chi-square)."""
        sd = port(**KW)
        cfg = dict(sampler="top_k", top_k=6, temperature=1.0,
                   max_batch_size=4)
        prompts = [PROMPTS[i % 2] for i in range(24)]

        def serve(seed, crash):
            d = str(tmp_path / f"s{seed}_{crash}")
            # no fsync: this reads its own journal back in one process,
            # and a disk the suite's other workers load made the fsync a
            # step most of the test's time
            with sd.flags(snapshot_interval_steps=3, journal_fsync="never"):
                eng = sd.engine(journal_dir=d, seed=seed, **cfg)
                reqs, streamed = _streamed_serve(eng, prompts, 8)
                if not crash:
                    eng.run()
                    return [r.generated_ids for r in reqs]
                for _ in range(7):
                    eng.step()
                eng._durability.flush()
                snap = sd.D.load_snapshot(d)
                eng2, rmap = sd.D.restore_from_dir(d, sd.model,
                                                   device="cpu")
            assert snap.rng is not None
            assert bytes(eng2._generator.get_state().numpy()) == \
                bytes.fromhex(snap.rng)
            _rewire(rmap, streamed)
            eng2.run()
            out = []
            for r in reqs:
                rid = r.request_id
                if rid in rmap:
                    assert streamed[rid] == rmap[rid].generated_ids
                    out.append(rmap[rid].generated_ids)
                else:
                    out.append(r.generated_ids)
                assert len(out[-1]) == 8
            return out

        ref, got = [], []
        for seed in range(4):
            ref += [t for o in serve(seed, False) for t in o]
            got += [t for o in serve(seed, True) for t in o]
        v = sd.model.cfg.vocab_size
        a = np.bincount(ref, minlength=v)
        b = np.bincount(got, minlength=v)
        cols = np.nonzero(a + b)[0]
        _, p, _, _ = sstats.chi2_contingency(np.stack([a[cols], b[cols]]))
        assert p > 1e-3, (a[cols], b[cols])


class TestDisarmedParity:
    def test_disarmed_bit_exact_zero_counters(self, reference):
        def scen(sd):
            outs = sd.engine().generate(PROMPTS, max_new_tokens=NEW)
            st = sd.stats()
            return outs, {k: st[k] for k in (
                "journal_records", "journal_snapshots", "restores",
                "exec_handoffs", "hung_steps", "retraces_after_warmup")}

        j, t = _both(scen)
        assert j == t and t[0] == reference and not any(t[1].values())

    def test_flags_arm_journal_and_watchdog(self, tmp_path, reference):
        sd = port(**KW)
        d = str(tmp_path / "flagged")
        with sd.flags(journal_dir=d):
            eng = sd.engine()
            assert eng._durability is not None
            assert eng.generate(PROMPTS, max_new_tokens=NEW) == reference
        assert os.path.exists(os.path.join(d, "journal.wal"))
        assert sd.engine()._durability is None
        with sd.flags(step_timeout_ms=250.0):
            assert sd.engine()._watchdog.timeout_ms == 250.0


# ---------------------------------------------------------------------------
# on the card: captured graphs across a handoff, capture in the
# frontend's worker thread, an abandoned worker that launches nothing
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    return torch.device("cuda")


def _card_model():
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    return GPT.random(GPTConfig(vocab_size=512, hidden_size=128,
                                num_layers=2, num_heads=2, max_seq_len=256),
                      seed=0, device="cuda")


@pytest.mark.cuda
def test_cuda_handoff_replays_adopted_graphs(cuda_device):
    from paddle_tpu_torch.inference import resilience, serving

    model = _card_model()
    ref = serving.DecodeEngine(model, **KW).generate(PROMPTS, NEW)
    eng = serving.DecodeEngine(model, **KW)
    for p in PROMPTS:
        eng.add_request(p, max_new_tokens=NEW)
    while not (eng._decode_fn and eng._decode_fn.captures):
        eng.step()
    graphs = eng.graph_captures()
    before = serving.decode_stats()
    new = resilience.recover(eng)
    assert new.graph_captures() == graphs  # adopted, none captured
    assert eng._k_pages is None and not eng._trackers()
    reqs = [rec.request for rec in resilience.EngineSnapshot(new).records]
    new.run()
    after = serving.decode_stats()
    assert after["mixed_compiles"] == before["mixed_compiles"]
    assert after["decode_compiles"] == before["decode_compiles"]
    assert sorted(r.generated_ids for r in reqs) == sorted(ref)
    assert new.pool.available_count == new.pool.num_pages


@pytest.mark.cuda
def test_cuda_frontend_captures_in_worker_and_abandons(cuda_device):
    """The frontend steps (and captures) in its worker thread; a stalled
    worker is abandoned and its late return launches nothing."""
    import time

    from paddle_tpu_torch.inference import frontend, serving
    from paddle_tpu_torch.ops import paged_attention as pa

    model = _card_model()
    ref = serving.DecodeEngine(model, **KW).generate(PROMPTS, NEW)
    eng = serving.DecodeEngine(model, fault_plan="slow_step@12;slow_ms=1500",
                               step_timeout_ms=300.0, **KW)
    pa.paged_attention_cuda.launches = 0

    async def go():
        async with frontend.ServingFrontend(eng) as fe:
            await (await fe.submit(PROMPTS[0], max_new_tokens=4)).collect()
            s = [await fe.submit(p, max_new_tokens=NEW) for p in PROMPTS]
            return fe, [await x.collect() for x in s]

    fe, toks = run(go())
    time.sleep(1.6)  # the abandoned worker wakes and returns
    torch.cuda.synchronize()
    assert toks == ref and fe._recoveries == 1
    steps = eng.decode_stats()["steps"] + fe.engine.decode_stats()["steps"]
    assert pa.paged_attention_cuda.launches == 2 * steps
