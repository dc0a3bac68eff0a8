"""Tensor-parallel serving in the port (``serve_mesh="mp=N"``) against the
unsharded engines of both packages and the JAX mesh engine, on CPU torch
over gloo: the contracts of tests/test_sharded_serving.py case by case.

* greedy tokens at mp=2 and mp=4 equal the port's unsharded ragged
  engine's and the JAX unsharded ragged engine's in plain decode,
  chunked mixed, speculative verify, int8 KV and int8 weights (where the
  JAX mesh exists, also the JAX mp=2 engine's tokens and flight records);
* one step signature a KV mode, no warm retrace; the int8 refold count
  summed over the ranks equals the global count;
* one sharded step's logits within 2e-5 of the unsharded step's;
* ``collective_bytes`` is 16384 on JAX's TINY probe (JAX's all-reduce
  bytes) and 0 off the mesh, the interconnect term follows
  ``FLAGS_peak_ici_gbps``, and probed sharded steps record chip skew;
* the off path keeps its fingerprint and shows no mesh; the flag arms
  the mesh, the argument wins, the wire config round-trips, the
  validation errors are JAX's, restore and recover rebuild sharded
  engines;
* the partition specs are JAX's but for the head-aligned qkv; a killed
  worker raises within its bound and leaves no process.

One mesh a spec serves the whole file (`parallel.mesh.get_mesh`)."""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as JS
from paddle_tpu.parallel import partition as JP
from paddle_tpu_torch.core import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.parallel import mesh as TM
from paddle_tpu_torch.parallel import partition as TP

from torch_telemetry_common import (deterministic, models, reset_both,
                                    TINY)

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 2,
    reason="needs the 8-device virtual CPU mesh (conftest)")

KW = dict(max_batch_size=2, max_seq_len=64, page_size=16)

# mode -> (engine options, prompt lengths, new tokens, model seed,
# prompt seed): the cases of tests/test_sharded_serving.py
MODES = {
    "decode": (dict(), (5, 9, 13), 10, 21, 11),
    "chunked": (dict(chunked_prefill=True, prefill_q_max=8), (5, 19, 11),
                8, 22, 12),
    "spec": (dict(spec_decode_k=3), (5, 9, 13), 10, 23, 13),
    "int8_kv": (dict(kv_quant="int8"), (6, 11), 8, 25, 15),
    "int8_weights": (dict(serve_weights="int8"), (6, 11), 8, 26, 16),
}
# f32 logits of one step, sharded against unsharded (the row-split
# products sum their halves in another order)
LOGIT_TOL = 2e-5


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lens]


def _torch_engine(tm, **kw):
    return TS.DecodeEngine(tm, device="cpu", **KW, **kw)


def _jax_engine(m, **kw):
    return JS.DecodeEngine(m, **KW, **kw)


_MODELS = {}


def _models(seed):
    if seed not in _MODELS:
        _MODELS[seed] = models(seed)
    return _MODELS[seed]


_REFS = {}


def _refs(mode):
    """(JAX ragged tokens and refolds, port ragged tokens and refolds)
    of one mode, computed once."""
    if mode not in _REFS:
        opts, lens, new, seed, pseed = MODES[mode]
        m, tm = _models(seed)
        ps = _prompts(pseed, lens)
        reset_both()
        je = _jax_engine(m, ragged_step=True, **opts)
        jout = je.generate(ps, new)
        jref = JS.decode_stats()["kv_quant_refolds"]
        TS.reset_decode_stats()
        te = _torch_engine(tm, ragged_step=True, **opts)
        tout = te.generate(ps, new)
        tref = TS.decode_stats()["kv_quant_refolds"]
        _REFS[mode] = (jout, jref, tout, tref)
    return _REFS[mode]


# ---------------------------------------------------------------------------
# token parity + the one-signature / zero-retrace contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_parity_one_signature(mode, mp):
    opts, lens, new, seed, pseed = MODES[mode]
    jout, jref, tout, tref = _refs(mode)
    _, tm = _models(seed)
    TS.reset_decode_stats()
    eng = _torch_engine(tm, serve_mesh=f"mp={mp}", **opts)
    assert eng._ragged and eng._mesh_mp == mp
    out = eng.generate(_prompts(pseed, lens), new)
    assert out == tout == jout
    st = TS.decode_stats()
    assert st["ragged_compiles"] == 1
    assert st["decode_compiles"] == st["mixed_compiles"] == 0
    assert st["verify_compiles"] == st["prefill_compiles"] == 0
    assert st["ragged_retraces"] == 0
    assert st["retraces_after_warmup"] == 0
    if mode == "spec":
        assert st["spec_steps"] > 0
    if mode == "int8_kv":
        # the ranks' refold counts sum to the global count
        assert st["kv_quant_refolds"] == tref == jref > 0
    # every rank holds its heads of the pools
    assert eng._k_pages.shape[1] == TINY["num_heads"] // mp


@needs_mesh
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_and_records_equal_jax_mesh(mode):
    """Port mp=2 against the JAX mp=2 engine: the same tokens and the same
    flight records in every deterministic field."""
    opts, lens, new, seed, pseed = MODES[mode]
    m, tm = _models(seed)
    ps = _prompts(pseed, lens)
    reset_both()
    je = _jax_engine(m, serve_mesh="mp=2", **opts)
    jout = je.generate(ps, new)
    reset_both()
    te = _torch_engine(tm, serve_mesh="mp=2", **opts)
    tout = te.generate(ps, new)
    assert tout == jout
    jrecs = [deterministic(r) for r in je._flight.records()]
    trecs = [deterministic(r) for r in te._flight.records()]
    assert trecs == jrecs


def test_legacy_prefill_parity():
    """``chunked_prefill=False`` on the mesh: the one-shot prefill is a
    sharded step too (JAX runs it over the sharded weights)."""
    _, tm = _models(21)
    ps = _prompts(11, (5, 9, 13))
    ref = _torch_engine(tm, chunked_prefill=False,
                        ragged_step=True).generate(ps, 6)
    TS.reset_decode_stats()
    eng = _torch_engine(tm, chunked_prefill=False, serve_mesh="mp=2")
    assert eng.generate(ps, 6) == ref
    st = TS.decode_stats()
    assert st["prefill_compiles"] >= 1 and st["retraces_after_warmup"] == 0


@pytest.mark.parametrize("mp", [2, 4])
def test_step_logits_within_tolerance(mp, monkeypatch):
    """The first step's logits (same weights, same inputs) on the mesh
    against the unsharded ragged engine's."""
    _, tm = _models(27)
    ps = _prompts(17, (5, 9))
    seen = []
    real = TS._sample

    def sample(params, h, eps, generator, sampling):
        seen.append(TS._logits_of(params, TS._ln(
            h, params["lnf_w"], params["lnf_b"], eps)).float().clone())
        return real(params, h, eps, generator, sampling)

    monkeypatch.setattr(TS, "_sample", sample)
    outs = []
    for kw in (dict(ragged_step=True), dict(serve_mesh=f"mp={mp}")):
        seen.clear()
        eng = _torch_engine(tm, **kw)
        for p in ps:
            eng.add_request(p, max_new_tokens=4)
        eng.step()
        outs.append(seen[0])
    a, b = outs
    assert a.shape == b.shape and torch.isfinite(b).all()
    assert (a - b).abs().max().item() <= LOGIT_TOL


# ---------------------------------------------------------------------------
# the sharded program: collective bytes + the interconnect term
# ---------------------------------------------------------------------------
def _probe_engine(**kw):
    """tests/test_sharded_serving.py's TINY probe: 2 slots x 16 ragged
    rows (page 16), 2 layers, h = 32."""
    _, tm = _models(26)
    eng = _torch_engine(tm, **kw)
    eng.generate(_prompts(16, (5, 9)), 4)
    return eng


def test_collective_bytes_on_sharded_profiles_only():
    from paddle_tpu_torch import observability as TO
    from paddle_tpu_torch.observability import costmodel

    costmodel.clear_profiles()
    TO.reset()
    eng = _probe_engine(serve_mesh="mp=2")
    prof = eng._cost.profile_for("ragged")
    assert prof.collective_bytes == TP.collective_bytes(
        rows=2 * 16, hidden=32, layers=2, mp=2) == 16384
    peaks = eng._cost.peaks
    base = max(prof.flops / peaks["flops"],
               prof.bytes_accessed / peaks["bytes_per_s"])
    assert eng._cost.raw_seconds(prof) == pytest.approx(
        base + prof.collective_bytes / peaks["ici_bytes_per_s"])
    site = eng._ragged_fn.site
    series = TO.snapshot()["paddle_collective_bytes"]["series"]
    assert {"labels": {"fn": site}, "value": 16384.0} in series

    costmodel.clear_profiles()
    one = _probe_engine(ragged_step=True)
    p1 = one._cost.profile_for("ragged")
    assert p1.collective_bytes == 0
    assert one._cost.raw_seconds(p1) == pytest.approx(
        max(p1.flops / one._cost.peaks["flops"],
            p1.bytes_accessed / one._cost.peaks["bytes_per_s"]))
    # int8 KV adds the refold count's reduction
    assert TP.collective_bytes(rows=32, hidden=32, layers=2, mp=2,
                               kv_int8=True) == 16388
    assert TP.collective_bytes(rows=32, hidden=32, layers=2, mp=1) == 0


@needs_mesh
def test_collective_bytes_equal_jax_all_reduce_bytes():
    """The port's count against the all-reduces of the JAX mp=2 step's
    optimized HLO on the same probe (JAX's all-gathers of qkv are left
    out by design: the port's qkv is split head-aligned)."""
    m, _ = _models(26)
    eng = _jax_engine(m, serve_mesh="mp=2")
    eng.generate(_prompts(16, (5, 9)), 4)
    q = eng._q_ragged
    lowered = eng._ragged_fn.fn.lower(
        eng._params, eng._k_pages, eng._v_pages, eng._dev(eng._bt),
        eng._dev(eng._lens), eng._dev(np.zeros((eng._slots, q), np.int32)),
        eng._dev(np.zeros((eng._slots,), np.int32)),
        eng._dev(jax.random.PRNGKey(0)))
    colls = JP.hlo_collectives(lowered.compile().as_text())
    ours = _probe_engine(serve_mesh="mp=2")._cost.profile_for("ragged")
    assert ours.collective_bytes == colls["all-reduce"]["bytes"] == 16384


def test_peak_ici_flag_moves_the_term(monkeypatch):
    from paddle_tpu_torch.observability.costmodel import resolve_peaks

    assert resolve_peaks()["ici_bytes_per_s"] == 1.0e10
    TF.set_flags({"FLAGS_peak_ici_gbps": 25.0})
    try:
        assert resolve_peaks()["ici_bytes_per_s"] == 25.0e9
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: "NVIDIA H100 80GB HBM3")
        assert resolve_peaks(torch.device("cuda"))[
            "ici_bytes_per_s"] == 25.0e9  # the flag wins
    finally:
        TF.set_flags({"FLAGS_peak_ici_gbps": 0.0})
    # the H100's NVLink 4: 450 GB/s a direction
    peaks = resolve_peaks(torch.device("cuda"))
    assert peaks["ici_bytes_per_s"] == 450e9
    assert (peaks["flops"], peaks["bytes_per_s"]) == (989e12, 3.35e12)


def test_chip_skew_probe_on_sharded_engine():
    """A probed sharded step records the ranks' completion skew
    (/profilez, the flight record, the gauge); the unsharded engine stays
    skew-silent."""
    from paddle_tpu_torch import observability as TO

    TO.reset()
    eng = _probe_engine(serve_mesh="mp=2", profile=True,
                        profile_sample_steps=1)
    sk = eng._profiling.statusz()["chip_skew_seconds"]
    assert sk is not None and sk["probes"] > 0
    assert sk["max_s"] >= sk["last_s"] >= 0.0
    assert any("chip_skew_s" in r.get("probe", {})
               for r in eng._flight.records())
    rows = TO.snapshot()["paddle_chip_skew_seconds"]["series"]
    assert any(r["labels"] == {"engine": str(eng._engine_id)}
               for r in rows)
    one = _probe_engine(ragged_step=True, profile=True,
                        profile_sample_steps=1)
    assert one._profiling.statusz()["chip_skew_seconds"] is None


# ---------------------------------------------------------------------------
# identity, config plumbing, and the strict off path
# ---------------------------------------------------------------------------
def test_off_path_bit_exact_and_fingerprint():
    _, tm = _models(29)
    on = _torch_engine(tm, serve_mesh="mp=2")
    off = _torch_engine(tm, serve_mesh="", ragged_step=True)
    default = _torch_engine(tm, ragged_step=True)
    assert on.config_fingerprint() != off.config_fingerprint()
    assert off.config_fingerprint() == default.config_fingerprint()
    assert off._mesh is None and default._mesh is None
    for eng in (off, default):
        z = eng.statusz()
        assert z["config"]["serve_mesh"] == ""
        assert z["config"]["mesh_devices"] == 1 and "mesh" not in z
    z = on.statusz()
    assert z["config"]["serve_mesh"] == "mp=2"
    assert z["config"]["mesh_devices"] == 2
    assert z["mesh"]["backend"] == "gloo"
    assert z["mesh"]["placement"] == ["cpu", "cpu"]
    ps = _prompts(19, (6, 9))
    assert off.generate(ps, 5) == default.generate(ps, 5)


@needs_mesh
def test_fingerprint_equals_jax_mesh():
    m, tm = _models(29)
    assert _torch_engine(tm, serve_mesh="mp=2").config_fingerprint() == \
        _jax_engine(m, serve_mesh="mp=2").config_fingerprint()


def test_flag_arms_mesh_and_arg_wins():
    _, tm = _models(30)
    p = _prompts(19, (6,))[0]
    ref = _torch_engine(tm, ragged_step=True).generate([p], 6)[0]
    TF.set_flags({"FLAGS_serve_mesh": "mp=2"})
    try:
        eng = _torch_engine(tm)
        assert eng._mesh is not None and eng._mesh_mp == 2
        assert eng.generate([p], 6)[0] == ref
        # the explicit argument beats the flag
        assert _torch_engine(tm, serve_mesh="")._mesh is None
    finally:
        TF.set_flags({"FLAGS_serve_mesh": ""})


def test_wire_config_round_trip_rebuilds_sharded():
    _, tm = _models(31)
    ps = _prompts(20, (5, 9))
    eng = _torch_engine(tm, serve_mesh="mp=2")
    refs = eng.generate(ps, 6)
    cfg = eng.wire_config()
    assert cfg["serve_mesh"] == "mp=2"
    cfg = json.loads(json.dumps(cfg))  # the journal's wire trip
    eng2 = TS.DecodeEngine(tm, device="cpu", **cfg)
    assert eng2._mesh is eng._mesh and eng2._mesh_mp == 2
    assert eng2.config_fingerprint() == eng.config_fingerprint()
    assert eng2.generate(ps, 6) == refs


@pytest.mark.parametrize("spec,match", [
    ("mp=two", "bad mesh spec"),
    ("dp=2,mp=2", "single tensor-parallel"),
    ("mp=8", "not divisible"),
    (None, "devices"),
    ("ragged", "ragged"),
])
def test_validation_errors(spec, match):
    """JAX's refusals, in JAX's order (the devices check before the
    heads'): ``None`` asks for more ranks than the host has places for
    (`parallel.mesh.rank_capacity`)."""
    _, tm = _models(32)
    kw = {}
    if spec is None:
        spec = f"mp={4 * TM.rank_capacity()}"
    elif spec == "ragged":
        spec, kw = "mp=2", dict(ragged_step=False)
    if spec == "mp=8" and TM.rank_capacity() < 8:
        spec = "mp=3"  # fits the host, does not divide 4 heads
    with pytest.raises(ValueError, match=match):
        _torch_engine(tm, serve_mesh=spec, **kw)
    # JAX's parser says the same about the same specs
    if match == "bad mesh spec":
        with pytest.raises(ValueError) as je:
            JP.parse_mesh_spec(spec)
        with pytest.raises(ValueError) as te:
            TP.parse_mesh_spec(spec)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kv", ["off", "int8"])
def test_restore_rebuilds_sharded_engine(tmp_path, kv):
    """Journal + snapshot (with its KV sidecar) of a sharded engine
    rebuild a sharded engine in place: the sidecar gathers every rank's
    heads and scatters them back, and the finished generations equal an
    uninterrupted serve's."""
    from paddle_tpu_torch.inference.durability import restore_from_dir

    _, tm = _models(33)
    ps = _prompts(21, (18, 21))
    reference = _torch_engine(tm, ragged_step=True,
                              kv_quant=kv).generate(ps, 8)
    d = str(tmp_path / "j")
    TF.set_flags({"snapshot_interval_steps": 3, "journal_fsync": "never"})
    try:
        eng = _torch_engine(tm, serve_mesh="mp=2", journal_dir=d,
                            kv_quant=kv)
        reqs = [eng.add_request(p, max_new_tokens=8) for p in ps]
        for _ in range(6):
            eng.step()
        eng._durability.flush()
        snap_kv = eng.pool.cached_count
        eng2, rmap = restore_from_dir(d, tm, device="cpu")
    finally:
        TF.set_flags({"snapshot_interval_steps": 32,
                      "journal_fsync": "step"})
    assert snap_kv > 0 and eng2.pool.cached_count > 0  # the sidecar
    assert eng2._mesh is not None and eng2._mesh_mp == 2
    assert eng2.config_fingerprint() == eng.config_fingerprint()
    eng2.run()
    order = sorted(rmap)
    assert sorted(r.request_id for r in reqs) == order
    assert [list(rmap[r].generated_ids) for r in order] == reference


def test_sidecar_gathers_every_head():
    """`_kv_gather` joins the ranks' heads into the unsharded layout and
    `_kv_put` scatters it back."""
    _, tm = _models(34)
    ps = _prompts(22, (17, 20))
    one = _torch_engine(tm, ragged_step=True)
    two = _torch_engine(tm, serve_mesh="mp=2")
    one.generate(ps, 3)
    two.generate(ps, 3)
    ids = sorted(one.pool._page_hash)
    assert ids == sorted(two.pool._page_hash)
    a, b = one._kv_gather(ids), two._kv_gather(ids)
    assert b["k"].shape == a["k"].shape
    np.testing.assert_allclose(b["k"], a["k"], atol=1e-5)
    np.testing.assert_allclose(b["v"], a["v"], atol=1e-5)
    two._kv_put(ids, {k: np.zeros_like(v) for k, v in b.items()})
    assert not two._kv_gather(ids)["k"].any()


def test_recover_hands_shards_to_successor():
    """`resilience.recover` of a sharded engine: the successor takes the
    workers' shards and the graphs with them, allocates nothing, and
    finishes with the uninterrupted tokens."""
    from paddle_tpu_torch.inference.resilience import recover

    _, tm = _models(35)
    ps = _prompts(23, (5, 9))
    ref = _torch_engine(tm, ragged_step=True).generate(ps, 8)
    eng = _torch_engine(tm, serve_mesh="mp=2")
    reqs = [eng.add_request(p, max_new_tokens=8) for p in ps]
    for _ in range(3):
        eng.step()
    shards = eng._mesh_shards
    new = recover(eng)
    assert new._mesh_shards is shards and eng._mesh_shards is None
    new.run()
    assert [list(r.generated_ids) for r in reqs] == ref


# ---------------------------------------------------------------------------
# partition rules and the weight bridge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_partition_specs_match_jax(weights):
    """Every leaf's spec equals JAX's `gpt_serving_rules` spec, the
    head-aligned qkv axis standing for JAX's contiguous ``"mp"``."""
    m, tm = _models(36)
    jparams = JS._extract_gpt_params(m)
    tparams = tm.params()
    if weights == "int8":
        jparams = JS._quantize_gpt_params(jparams)[0]
        tparams = TS._quantize_gpt_params(tparams)[0]
    assert TP.tree_path_names(tparams) == JP.tree_path_names(jparams)
    jspecs = jax.tree_util.tree_leaves(
        JP.match_partition_rules(JP.gpt_serving_rules(), jparams),
        is_leaf=lambda x: isinstance(x, JP.P))
    tspecs = [TP._at(TP.match_partition_rules(TP.gpt_serving_rules(),
                                              tparams), p.split("/"))
              for p in TP.tree_path_names(tparams)]
    qkv = 0
    for name, j, t in zip(TP.tree_path_names(tparams), jspecs, tspecs):
        mapped = tuple("mp" if a == TP.QKV_HEADS else a for a in t)
        assert mapped == tuple(j), name
        qkv += TP.QKV_HEADS in t
    # qkv_w and qkv_b a block; int8 adds the weight's scale
    assert qkv == TINY["num_layers"] * (3 if weights == "int8" else 2)
    assert tuple(TP.kv_pages_spec()) == tuple(JP.kv_pages_spec())
    assert tuple(TP.kv_scales_spec()) == tuple(JP.kv_scales_spec())


def test_unmatched_leaf_raises_and_scalars_replicate():
    with pytest.raises(ValueError, match="Partition rule not found"):
        TP.match_partition_rules([(r"^a$", TP.P("mp"))],
                                 {"b": torch.zeros(4)})
    specs = TP.match_partition_rules([(r".*", TP.P("mp"))],
                                     {"s": torch.zeros(()),
                                      "one": torch.zeros(1)})
    assert specs == {"s": TP.P(), "one": TP.P()}


@pytest.mark.parametrize("mp", [2, 4])
def test_shards_join_back_and_hold_whole_heads(mp):
    _, tm = _models(37)
    params = TS._quantize_gpt_params(tm.params())[0]
    params["blocks"][0]["qkv_w"] = tm.params()["blocks"][0]["qkv_w"]
    specs = TP.match_partition_rules(TP.gpt_serving_rules(), params)
    shards = TP.shard_params(params, specs, mp)
    back = TP.gather_params(shards, specs)
    for (pa_, a), (pb, b) in zip(TP._walk(params), TP._walk(back)):
        assert pa_ == pb and torch.equal(a, b), pa_
    # rank r's qkv columns are q, k and v of heads r*H/mp .. (r+1)*H/mp
    h, nh = TINY["hidden_size"], TINY["num_heads"]
    d, per = h // nh, nh // mp
    w = params["blocks"][0]["qkv_w"].reshape(h, 3, nh, d)
    for r, sh in enumerate(shards):
        got = sh["blocks"][0]["qkv_w"].reshape(h, 3, per, d)
        assert torch.equal(got, w[:, :, r * per:(r + 1) * per])
        assert sh["blocks"][0]["out_w_q"].shape[0] == h // mp
        assert sh["wte"] is params["wte"]


# ---------------------------------------------------------------------------
# the runtime: imports, worker death, no process left
# ---------------------------------------------------------------------------
def test_workers_import_only_the_port():
    _, tm = _models(38)
    eng = _torch_engine(tm, serve_mesh="mp=2")
    eng.generate(_prompts(24, (5,)), 3)
    mesh = eng._mesh
    assert mesh.foreign_modules == {1: []}
    (st,) = mesh.stats()
    assert st["foreign_modules"] == [] and st["engines"] >= 1
    assert st["pid"] == mesh.workers[0].pid != os.getpid()


def test_killed_worker_raises_within_bound(monkeypatch):
    """A worker killed mid-serve: the controller's next step raises
    `MeshError` within the bound (5 s here; death closes the worker's
    pipe and sockets at once), the engine raises it unretried, the next
    `get_mesh` replaces the broken mesh, and no worker is left."""
    monkeypatch.setattr(TM, "_MESHES", {})  # a mesh of its own
    _, tm = _models(39)
    eng = _torch_engine(tm, serve_mesh="mp=2")
    mesh = eng._mesh
    procs = mesh.workers
    for p in _prompts(25, (5, 9)):
        eng.add_request(p, max_new_tokens=16)
    eng.step()
    os.kill(procs[0].pid, signal.SIGKILL)
    procs[0].wait(timeout=10)
    t0 = time.monotonic()
    with pytest.raises(TM.MeshError, match="lost|broken"):
        for _ in range(4):
            eng.step()
    assert time.monotonic() - t0 < 5.0
    assert not mesh.usable()
    fresh = TM.get_mesh("mp=2", "cpu")
    assert fresh is not mesh and fresh.usable()
    assert all(p.poll() is not None for p in procs)
    TM.shutdown_all()
    assert all(p.poll() is not None for p in fresh.workers)



# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["mp=1", "mp=2"])
def test_cuda_mesh_matches_cpu(cuda_device, spec):
    """The mesh on the card (head_dim 64, K1 at the shard's heads): the
    CPU's unsharded greedy tokens, K1 launched once a layer a step on
    every rank.  mp=1 runs NCCL with captured steps (its all-reduces
    recorded in the graph); mp=2 on one card shares it over gloo,
    eagerly."""
    from paddle_tpu_torch.models.gpt import GPT as TGPT
    from paddle_tpu_torch.models.gpt import GPTConfig as TGPTConfig
    from paddle_tpu_torch.ops import paged_attention as TPA

    cfg = TGPTConfig(vocab_size=96, hidden_size=128, num_layers=2,
                     num_heads=2, max_seq_len=128)
    prompts = _prompts(3, (5, 40, 13, 70))
    kw = dict(max_batch_size=2, max_seq_len=128, page_size=16)
    cpu = TS.DecodeEngine(TGPT.random(cfg, seed=3, device="cpu"),
                          device="cpu", **kw).generate(prompts, 10)
    eng = TS.DecodeEngine(TGPT.random(cfg, seed=3, device=cuda_device),
                          serve_mesh=spec, **kw)
    mesh = eng._mesh
    mesh.stats(reset=True)
    before = TPA.paged_attention_cuda.launches
    assert eng.generate(prompts, 10) == cpu
    st = eng.decode_stats()
    assert st["ragged_steps"] == st["steps"]
    want = 2 * st["steps"]
    assert TPA.paged_attention_cuda.launches - before == want
    assert [w["launches"]["K1"] for w in mesh.stats()] == \
        [want] * (mesh.mp - 1)
    if torch.cuda.device_count() >= mesh.mp:
        assert mesh.backend == "nccl" and eng.graph_captures() == 1
    else:
        assert mesh.backend == "gloo" and eng.graph_captures() == 0
