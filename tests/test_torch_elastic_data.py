"""The port's elastic membership, fleet datasets and DataLoader worker
processes against the JAX package's.

* ``fleet.elastic``: a JAX and a port `ElasticManager` share one
  `FileKVStore` directory and agree on the members, the ranks and every
  re-ranking their watch loops report.
* ``fleet.dataset``: `QueueDataset` and `InMemoryDataset` (loads, a
  ``pipe_command``, local and global shuffles) over the same MultiSlot
  files give batches bit-equal to the JAX package's.
* ``io.DataLoader(num_workers > 0)``: spawned workers (persistent, with
  ``worker_init_fn``, a truncated epoch) give the ``num_workers=0``
  batches and the JAX loader's bit for bit, hand over in shared memory
  and see no card; a worker's exception and a ``timeout`` raise in the
  parent; the thread mode gives the same batches.  The datasets live in
  tests/torch_data_common.py, which a worker imports.
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import gzip
import os
import sys
import time

import numpy as np
import pytest

from paddle_tpu import io as JIO
from paddle_tpu.distributed.fleet import dataset as JD
from paddle_tpu.distributed.fleet import elastic as JE

from paddle_tpu_torch import io as TIO
from paddle_tpu_torch.distributed import fleet as TF
from paddle_tpu_torch.distributed.fleet import dataset as TD
from paddle_tpu_torch.distributed.fleet import elastic as TE

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_data_common as C  # noqa: E402


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------
def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_elastic_managers_share_a_store(tmp_path):
    root = str(tmp_path / "kv")
    seen = {"jax": [], "port": []}
    jm = JE.ElasticManager(JE.FileKVStore(root), job_id="job",
                           host="10.0.0.2:6070", np_target=3,
                           watch_interval_s=0.05,
                           on_restart=seen["jax"].append)
    tm = TE.ElasticManager(TE.FileKVStore(root), job_id="job",
                           host="10.0.0.1:6070", np_target=3,
                           watch_interval_s=0.05,
                           on_restart=seen["port"].append)
    jm.register()
    tm.register()
    assert tm.hosts() == jm.hosts() == ["10.0.0.1:6070", "10.0.0.2:6070"]
    assert not tm.match() and tm.status() == TE.ElasticStatus.HOLD
    assert jm.status() == JE.ElasticStatus.HOLD
    jm.start()
    tm.start()
    try:
        third = TE.ElasticManager(TE.FileKVStore(root), job_id="job",
                                  host="10.0.0.0:6070", np_target=3)
        third.register()
        assert _wait(lambda: seen["jax"] and seen["port"])
        assert seen["port"][-1] == seen["jax"][-1] == {
            "10.0.0.0:6070": 0, "10.0.0.1:6070": 1, "10.0.0.2:6070": 2}
        assert tm.match() and tm.status() == TE.ElasticStatus.COMPLETED
        jm.deregister()  # scale in: the others re-rank
        assert _wait(lambda: len(seen["port"]) == 2 and
                     len(seen["jax"]) == 2)
        assert seen["port"][-1] == seen["jax"][-1] == {
            "10.0.0.0:6070": 0, "10.0.0.1:6070": 1}
        assert TE.FileKVStore(root).list("job/nodes") == \
            JE.FileKVStore(root).list("job/nodes")
    finally:
        jm.stop()
        tm.stop()


# ---------------------------------------------------------------------------
# fleet datasets
# ---------------------------------------------------------------------------
class _Var:
    def __init__(self, name, dtype, shape):
        self.name, self.dtype, self.shape = name, dtype, shape


_VARS = [_Var("ids", "int64", [-1, 1]), _Var("dense", "float32", [-1, 2]),
         _Var("label", "int64", [-1])]


def _multislot_files(tmp_path, gz=False):
    rng = np.random.RandomState(0)
    paths = []
    for f in range(3):
        lines = []
        for _ in range(7 + f):
            n = rng.randint(1, 5)
            ids = " ".join(str(v) for v in rng.randint(0, 1000, n))
            dense = " ".join(f"{v:.4f}" for v in rng.randn(2))
            lines.append(f"{n} {ids} 2 {dense} 1 {rng.randint(0, 2)}")
        text = "\n".join(lines) + "\n"
        p = tmp_path / (f"part-{f}.txt" + (".gz" if gz else ""))
        if gz:
            with gzip.open(p, "wt") as fh:
                fh.write(text)
        else:
            p.write_text(text)
        paths.append(str(p))
    return paths


def _batches(ds):
    return [{k: np.array(v) for k, v in b.items()}
            for b in ds.iter_batches()]


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_dataset_batches_match_jax(tmp_path, kind):
    files = _multislot_files(tmp_path)
    out = {}
    for name, mod in (("port", TD), ("jax", JD)):
        ds = mod.DatasetFactory().create_dataset(kind)
        ds.init(batch_size=4, thread_num=2, use_var=_VARS)
        ds.set_filelist(files)
        if kind == "InMemoryDataset":
            ds.load_into_memory()
            assert ds.get_memory_data_size() == 24
        out[name] = _batches(ds)
    _same(out["port"], out["jax"])
    assert out["port"][0]["label"].shape == (4,)
    assert "ids.lod" in out["port"][0]


def test_in_memory_shuffles_and_pipe_command_match_jax(tmp_path):
    files = _multislot_files(tmp_path, gz=True)
    out = {}
    for name, mod in (("port", TD), ("jax", JD)):
        ds = mod.InMemoryDataset()
        ds.init(batch_size=5, thread_num=3, use_var=_VARS,
                pipe_command="zcat")
        ds.set_filelist(files)
        ds.preload_into_memory(thread_num=2)
        ds.wait_preload_done()
        runs = [_batches(ds)]
        ds.local_shuffle()
        runs.append(_batches(ds))
        ds.global_shuffle()
        runs.append(_batches(ds))
        ds.load_into_memory(is_shuffle=True)
        runs.append(_batches(ds))
        assert ds.get_shuffle_data_size() == 24
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
        out[name] = runs
    for got, want in zip(out["port"], out["jax"]):
        _same(got, want)
    assert TF.InMemoryDataset is TD.InMemoryDataset
    with pytest.raises(ValueError, match="unknown dataset class"):
        TD.DatasetFactory().create_dataset("BoxPSDataset")


# ---------------------------------------------------------------------------
# DataLoader worker processes
# ---------------------------------------------------------------------------
def _arrays(loader, n=2):
    return [tuple(t.numpy() for t in b[:n]) for b in loader]


def _same_arrays(got, want, dtypes=True):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype or not dtypes
            np.testing.assert_array_equal(a, b)


def test_process_workers_match_zero_workers_and_jax():
    ds = C.BigDs()
    zero = _arrays(TIO.DataLoader(ds, places="cpu", batch_size=4))
    jax_ref = [tuple(np.asarray(t.numpy()) for t in b[:2])
               for b in JIO.DataLoader(ds, batch_size=4)]
    # JAX's tensors hold int64 labels as int32 (x64 off): values only
    _same_arrays(zero, jax_ref, dtypes=False)
    dl = TIO.DataLoader(ds, places="cpu", batch_size=4, num_workers=2,
                        multiprocess_mode="process", persistent_workers=True,
                        worker_init_fn=C.check_worker)
    try:
        got = [tuple(t.numpy() for t in b) for b in dl]
        _same_arrays([g[:2] for g in got], zero)
        pids = {int(p) for g in got for p in g[2]}
        assert len(pids) == 2 and os.getpid() not in pids
        pool = dl._pool
        assert pool is not None and pool.alive()
        it = iter(dl)  # a truncated epoch leaves batches in flight
        next(it)
        it.close()
        _same_arrays(_arrays(dl), zero)
        assert dl._pool is pool  # the same processes served every epoch
    finally:
        dl._pool.shutdown()


@pytest.mark.parametrize("case", ["crash", "timeout"])
def test_worker_failure_raises_in_the_parent(case):
    if case == "crash":
        dl = TIO.DataLoader(C.CrashDs(), places="cpu", batch_size=4,
                            num_workers=2)
        with pytest.raises(RuntimeError, match="poison sample"):
            list(dl)
    else:
        dl = TIO.DataLoader(C.SlowDs(), places="cpu", batch_size=1,
                            num_workers=2, timeout=1)
        with pytest.raises(RuntimeError, match="timed out"):
            list(dl)
    assert dl._pool is None  # the workers were shut down


def test_thread_workers_and_unpicklable_fallback():
    ds = C.BigDs()
    zero = _arrays(TIO.DataLoader(ds, places="cpu", batch_size=5))
    _same_arrays(_arrays(TIO.DataLoader(ds, places="cpu", batch_size=5,
                                        num_workers=3,
                                        multiprocess_mode="thread")), zero)
    # a lambda does not pickle: the threads serve, as in the JAX package
    dl = TIO.DataLoader(ds, places="cpu", batch_size=5, num_workers=2,
                        collate_fn=lambda items: TIO.default_collate_fn(
                            items))
    with pytest.warns(UserWarning, match="falling back to threads"):
        _same_arrays(_arrays(dl), zero)
    assert TIO.get_worker_info() is None
