"""A journal moves between the packages: the write-ahead journal,
snapshot and KV sidecar that one package's engine writes are read by the
other's readers into equal records, and the other package's
`restore_from_dir` finishes the serve with the writer's greedy tokens.

The config records carry the same keys (the telemetry plane's and the
mesh's included), and every key either package writes, the other takes.
The fingerprints are equal (`DecodeEngine.config_fingerprint`), so each
package validates the other's journal.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import os

import numpy as np
import pytest

from torch_reliability_common import Side

KW = dict(max_batch_size=2, max_seq_len=96, page_size=4)
PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2],
           [7, 8, 9, 7, 8, 9, 7, 8]]
NEW = 16
# config keys only the JAX engine journals: none since the port serves
# the mesh (``serve_mesh``) and the telemetry plane
JAX_ONLY_CFG = set()


def _sides():
    jx, pt = Side("jax", **KW), Side("torch", **KW)
    jx.reset()
    pt.reset()
    return jx, pt


def _dead_serve(sd, d, **kw):
    """Serve ``PROMPTS`` partway with the journal and 3-step snapshots
    armed, then drop the engine; returns (engine, streamed, reference)."""
    ref = sd.engine(**kw).generate(PROMPTS, max_new_tokens=NEW)
    streamed = {}
    with sd.flags(snapshot_interval_steps=3):
        eng = sd.engine(journal_dir=d, **kw)
        for p in PROMPTS:
            r = eng.add_request(p, max_new_tokens=NEW)
            r.on_token = (lambda rid: lambda t: streamed.setdefault(
                rid, []).append(t))(r.request_id)
        for _ in range(7):
            eng.step()
    eng._durability.flush()
    return eng, streamed, ref


def _finish(sd, d, streamed, **dev):
    eng, rmap = sd.D.restore_from_dir(d, sd.model, **dev)
    for rid, req in rmap.items():
        req.on_token = (lambda r: lambda t: streamed.setdefault(
            r, []).append(t))(rid)
    eng.run()
    order = sorted(rmap)
    return ([list(rmap[r].generated_ids) for r in order],
            [streamed[r] for r in order], eng)


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_jax_journal_read_and_restored_by_the_port(tmp_path, kv_quant):
    jx, pt = _sides()
    d = str(tmp_path / "j")
    jeng, streamed, ref = _dead_serve(jx, d, kv_quant=kv_quant)
    path = os.path.join(d, "journal.wal")
    # the readers agree record for record
    assert pt.D.read_journal(path) == jx.D.read_journal(path)
    jsnap, tsnap = jx.D.load_snapshot(d), pt.D.load_snapshot(d)
    assert tsnap.to_obj() == jsnap.to_obj() and tsnap.kv
    cfg = pt.D.read_journal(path)[0][0]
    assert cfg["fp"] == pt.engine(kv_quant=kv_quant).config_fingerprint(
        ).hex()
    # the sidecar's pages go in as the JAX engine held them
    teng, rmap = pt.D.restore_from_dir(d, pt.model, device="cpu")
    installed = {h: p for p, h in teng.pool._page_hash.items()}
    jpages = {h: p for p, h in jeng.pool._page_hash.items()}
    assert installed and set(installed) <= set(jpages)
    names = ["_k_pages", "_v_pages"] + (
        ["_k_scales", "_v_scales"] if kv_quant == "int8" else [])
    for h, p in installed.items():
        for name in names:
            np.testing.assert_array_equal(
                getattr(teng, name)[:, :, p].numpy(),
                np.asarray(getattr(jeng, name))[:, :, jpages[h]])
    # the port finishes the JAX serve: JAX's greedy tokens, every token
    # streamed exactly once across the two lives and the two packages
    for rid, req in rmap.items():
        req.on_token = (lambda r: lambda t: streamed.setdefault(
            r, []).append(t))(rid)
    teng.run()
    order = sorted(rmap)
    assert [list(rmap[r].generated_ids) for r in order] == ref
    assert [streamed[r] for r in order] == ref


def test_port_journal_read_and_restored_by_jax(tmp_path):
    jx, pt = _sides()
    d = str(tmp_path / "j")
    _, streamed, ref = _dead_serve(pt, d)
    path = os.path.join(d, "journal.wal")
    assert jx.D.read_journal(path) == pt.D.read_journal(path)
    assert jx.D.load_snapshot(d).to_obj() == pt.D.load_snapshot(d).to_obj()
    toks, logs, _ = _finish(jx, d, streamed)
    assert toks == logs == ref
    assert [list(map(int, t)) for t in toks] == ref


def test_records_and_config_equal_across_packages(tmp_path):
    """The same serve journaled by both packages: every admission,
    watermark and finish record equal, the fingerprints equal, and the
    config records equal but for the JAX engine's telemetry keys."""
    out = []
    for sd in _sides():
        d = str(tmp_path / sd.name)
        sd.reset()
        eng = sd.engine(journal_dir=d)
        eng.generate(PROMPTS, max_new_tokens=NEW)
        eng._durability.flush()
        out.append(sd.D.read_journal(os.path.join(d, "journal.wal"))[0])
    (jcfg, *jrec), (tcfg, *trec) = out
    assert jrec == trec
    assert jcfg["fp"] == tcfg["fp"]
    assert set(jcfg["cfg"]) - set(tcfg["cfg"]) == JAX_ONLY_CFG
    assert not set(tcfg["cfg"]) - set(jcfg["cfg"])
    assert {k: jcfg["cfg"][k] for k in tcfg["cfg"]} == tcfg["cfg"]


def test_port_restore_refuses_a_sharded_journal(tmp_path):
    """A sharded journal is restored, not refused: its config record
    keeps ``serve_mesh`` (`durability._engine_kwargs`; a None spec is
    dropped), the port rebuilds a sharded engine, and it finishes the
    serve with the unsharded engine's greedy tokens, each streamed
    once."""
    jx, pt = _sides()
    d = str(tmp_path / "j")
    _, streamed, ref = _dead_serve(pt, d, serve_mesh="mp=2")
    assert ref == pt.engine(ragged_step=True).generate(
        PROMPTS, max_new_tokens=NEW)
    cfg = pt.D.read_journal(os.path.join(d, "journal.wal"))[0][0]["cfg"]
    assert pt.D._engine_kwargs(cfg) == cfg and cfg["serve_mesh"] == "mp=2"
    assert "serve_mesh" not in pt.D._engine_kwargs(dict(cfg,
                                                        serve_mesh=None))
    toks, logs, eng = _finish(pt, d, streamed, device="cpu")
    assert eng._mesh_mp == 2 and eng._k_pages.shape[1] == 2
    assert toks == logs == ref
