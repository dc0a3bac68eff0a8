"""The port's parameter server against the JAX package's
(paddle_tpu/distributed/ps/).

Both packages drive the native core of ``csrc/ps_server.cc``: the JAX
package through its runtime library, the port through its own build of
that file alone (`paddle_tpu_torch.distributed.ps._native`).  So every
check is exact (bit-equal arrays): the same operation sequences on each
table kind of a JAX server and a port server, a port client on a JAX
server and the reverse, the communicator's geo mode, the sharded client
over two servers with save, kill and restart, the SSD table's spill and
restart, seeded graph sampling, the heterogeneous service's codec and
round trip, and the fleet's server and trainer roles from a patched
environment.  The async communicator merges on its own clock, so its
check is the total update (1e-6, JAX's own test's bound).
"""
import torch_test_env  # noqa: F401  (first: one intra-op thread)
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import ps as J

from paddle_tpu_torch.distributed import ps as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_native_common import jax_native, load_jax_native  # noqa: E402,F401

# the JAX servers need the JAX package's native runtime, built once under
# a lock whichever xdist worker asks first; loaded before test_ps, whose
# import asks for it too
load_jax_native()
from test_ps import _sample_hash_np  # noqa: E402

pytestmark = pytest.mark.usefixtures("jax_native")

PKGS = {"jax": J, "port": T}


def _serve(pkg, build, n_trainers=1):
    srv = pkg.PSServer()
    build(srv)
    return srv, srv.start(0, n_trainers=n_trainers)


def _close(srv, *clients):
    for c in clients:
        c.close()
    srv.stop()


def test_port_library_is_built_from_the_shared_source():
    from paddle_tpu_torch.distributed.ps import _native

    lib = _native.build()
    assert lib.parent.name == "paddle_tpu_torch"
    assert lib.name.startswith("libps_server_") and lib.exists()
    assert _native.SOURCE.name == "ps_server.cc"
    assert _native.SOURCE.parent.name == "csrc"
    assert _native.load().ptrt_ps_client_request is not None


def _dense_sequence(pkg, opt):
    srv, port = _serve(pkg, lambda s: s.create_dense_table(0, 6, 0.1, opt))
    c = pkg.PSClient(port=port)
    rng = np.random.RandomState(0)
    out = []
    c.set_dense(0, rng.randn(6).astype(np.float32))
    out.append(c.pull_dense(0, 6))
    for _ in range(3):
        c.push_dense_grad(0, rng.randn(6).astype(np.float32))
        out.append(c.pull_dense(0, 6))
    c.push_dense_delta(0, rng.randn(6).astype(np.float32))
    out.append(c.pull_dense(0, 6))
    _close(srv, c)
    return out


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "sum", "adam"])
def test_dense_table_matches_jax(opt):
    for got, want in zip(_dense_sequence(T, opt), _dense_sequence(J, opt)):
        np.testing.assert_array_equal(got, want)


def _sparse_sequence(pkg, opt):
    srv, port = _serve(pkg, lambda s: s.create_sparse_table(3, 4, 0.5, opt))
    c = pkg.PSClient(port=port)
    rng = np.random.RandomState(1)
    ids = np.array([5, 9, 5, 1 << 40], np.uint64)
    out = [c.pull_sparse(3, ids, 4)]
    for _ in range(3):
        c.push_sparse_grad(3, ids, rng.randn(4, 4).astype(np.float32))
        out.append(c.pull_sparse(3, ids, 4))
    _close(srv, c)
    return out


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_sparse_table_matches_jax(opt):
    for got, want in zip(_sparse_sequence(T, opt),
                         _sparse_sequence(J, opt)):
        np.testing.assert_array_equal(got, want)


def _mixed_session(client_pkg, server_pkg, tmp_path):
    """Dense, sparse and graph operations, a barrier and a save through
    one client of ``client_pkg`` on a server of ``server_pkg``."""

    def build(s):
        s.create_dense_table(0, 5, 0.1, "sgd")
        s.create_sparse_table(1, 3, 0.5, "sgd")
        s.create_graph_table(2, feat_dim=2)

    srv, port = _serve(server_pkg, build)
    c = client_pkg.PSClient(port=port)
    out = {}
    c.set_dense(0, np.arange(5, dtype=np.float32))
    c.push_dense_grad(0, np.full(5, 0.5, np.float32))
    out["dense"] = c.pull_dense(0, 5)
    c.push_sparse_grad(1, np.array([7, 8], np.uint64),
                       np.ones((2, 3), np.float32))
    out["sparse"] = c.pull_sparse(1, np.array([8, 7, 6], np.uint64), 3)
    c.add_graph_edges(2, np.array([1, 1, 2], np.uint64),
                      np.array([3, 4, 5], np.uint64),
                      np.array([1.0, 2.0, 3.0], np.float32))
    out["nbrs"], out["counts"] = c.sample_neighbors(
        2, np.array([1, 2, 9], np.uint64), 2, seed=3)
    c.set_node_feat(2, np.array([3], np.uint64),
                    np.array([[1.5, 2.5]], np.float32))
    out["feat"] = c.get_node_feat(2, np.array([3, 4], np.uint64), 2)
    c.barrier(trainer_id=0)
    snap = tmp_path / f"{client_pkg.__name__}_{server_pkg.__name__}.snap"
    c.save_tables(str(snap))
    out["saved"] = snap.exists() and snap.stat().st_size > 0
    _close(srv, c)
    return out


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_one_wire_format_across_packages(client, server, tmp_path):
    got = _mixed_session(PKGS[client], PKGS[server], tmp_path)
    want = _mixed_session(J, J, tmp_path)
    assert got["saved"] and want["saved"]
    for k in ("dense", "sparse", "nbrs", "counts", "feat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torch_tensors_at_the_boundary():
    srv, port = _serve(T, lambda s: (s.create_dense_table(0, 4, 0.1),
                                     s.create_sparse_table(1, 2, 0.5)))
    c = T.PSClient(port=port)
    c.set_dense(0, torch.arange(4, dtype=torch.float64))
    c.push_dense_grad(0, torch.ones(4))
    got = c.pull_dense(0, 4)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.arange(4, dtype=np.float32) - np.float32(0.1))
    c.push_sparse_grad(1, torch.tensor([3]), torch.ones(1, 2))
    np.testing.assert_array_equal(c.pull_sparse(1, torch.tensor([3]), 2),
                                  np.full((1, 2), -0.5, np.float32))
    _close(srv, c)


@pytest.mark.parametrize("seed", [0, 42])
def test_graph_sampling_matches_jax_and_replay(seed):
    deg, node, k = 10, 7, 4
    dst = np.arange(100, 100 + deg, dtype=np.uint64)
    w = np.linspace(0.5, 5.0, deg).astype(np.float32)
    res = {}
    for name, pkg in PKGS.items():
        srv, port = _serve(pkg, lambda s: s.create_graph_table(0, 0))
        c = pkg.PSClient(port=port)
        c.add_graph_edges(0, np.full(deg, node, np.uint64), dst, w)
        res[name] = c.sample_neighbors(0, np.array([node], np.uint64), k,
                                       seed=seed)
        _close(srv, c)
    np.testing.assert_array_equal(res["port"][0], res["jax"][0])
    np.testing.assert_array_equal(res["port"][1], res["jax"][1])
    keys = sorted((-(((float(_sample_hash_np(seed, node, j)) + 1.0)
                      / 2 ** 32) ** (1.0 / float(w[j]))), j)
                  for j in range(deg))
    assert res["port"][0][0, :k].tolist() == [int(dst[j])
                                              for _, j in keys[:k]]


def test_ssd_table_spill_and_restart(tmp_path):
    dim, budget, n_rows = 4, 8, 40
    ids = np.arange(1, n_rows + 1, dtype=np.uint64)
    res = {}
    for name, pkg in PKGS.items():
        spill, snap = tmp_path / f"{name}.spill", tmp_path / f"{name}.snap"

        def build(s):
            s.create_sparse_table_ssd(0, dim, budget, str(spill), lr=0.5,
                                      optimizer="adagrad")

        srv, port = _serve(pkg, build)
        c = pkg.PSClient(port=port)
        for i, rid in enumerate(ids):
            c.push_sparse_grad(0, np.array([rid], np.uint64),
                               np.full((1, dim), float(i + 1), np.float32))
        first = c.pull_sparse(0, ids, dim)
        assert spill.exists() and spill.stat().st_size > 0
        c.save_tables(str(snap))
        _close(srv, c)
        srv = pkg.PSServer()
        build(srv)
        srv.load(str(snap))
        c = pkg.PSClient(port=srv.start(0, n_trainers=1))
        c.push_sparse_grad(0, ids[:3], np.ones((3, dim), np.float32))
        res[name] = (first, c.pull_sparse(0, ids, dim))
        _close(srv, c)
    for got, want in zip(res["port"], res["jax"]):
        np.testing.assert_array_equal(got, want)


def _sharded(pkg, sizes):
    servers, eps = [], []
    for size in sizes:
        def build(s, size=size):
            s.create_dense_table(0, size, 0.1, "sgd")
            s.create_sparse_table(1, 3, 0.5, "sgd")

        srv, port = _serve(pkg, build)
        servers.append(srv)
        eps.append(f"127.0.0.1:{port}")
    return servers, eps


def test_sharded_client_save_kill_restart(tmp_path):
    sizes = T.shard_dense_sizes(11, 2)
    assert sizes == J.shard_dense_sizes(11, 2) == [6, 5]
    servers, eps = _sharded(T, sizes)
    c = T.ShardedPSClient(eps)
    c.register_dense(0, 11)
    v = np.arange(11, dtype=np.float32)
    c.set_dense(0, v)
    c.push_dense_grad(0, np.ones(11, np.float32))
    ids = np.array([2, 3, 5, 8], np.uint64)
    c.push_sparse_grad(1, ids, np.ones((4, 3), np.float32))
    blocks = [T.PSClient(port=int(e.rsplit(":", 1)[1])) for e in eps]
    want = v - np.float32(0.1)
    np.testing.assert_array_equal(blocks[0].pull_dense(0, 6), want[:6])
    np.testing.assert_array_equal(blocks[1].pull_dense(0, 5), want[6:])
    # ids route by modulo: the odd ones never touched server 0
    np.testing.assert_array_equal(
        blocks[0].pull_sparse(1, np.array([3, 5], np.uint64), 3), 0.0)
    prefix = str(tmp_path / "ckpt")
    c.save_tables(prefix)
    c.close()
    for s, b in zip(servers, blocks):  # kill
        _close(s, b)
    restarted, new_eps = [], []
    for i in range(2):
        s = T.PSServer()
        s.load(f"{prefix}.shard{i}")
        restarted.append(s)
        new_eps.append(("127.0.0.1", s.start(0, n_trainers=1)))
    c2 = T.ShardedPSClient(new_eps)
    np.testing.assert_array_equal(c2.pull_dense(0, 11), want)
    np.testing.assert_array_equal(c2.pull_sparse(1, ids, 3),
                                  np.full((4, 3), -0.5, np.float32))
    # the JAX package's sharded client reads the port's restarted shards
    jc = J.ShardedPSClient(new_eps)
    np.testing.assert_array_equal(jc.pull_dense(0, 11), want)
    jc.close()
    c2.close()
    for s in restarted:
        s.stop()


def _geo_run(pkg):
    srv, port = _serve(pkg, lambda s: s.create_dense_table(1, 4, 0.1, "sum"))
    c = pkg.PSClient(port=port)
    comm = pkg.Communicator(c, mode="geo", k_steps=2)
    local, seen = np.zeros(4, np.float32), []
    for step in range(4):
        local = comm.geo_step(1, local + np.float32(0.25 * (step + 1)))
        seen.append(np.array(local))
    seen.append(c.pull_dense(1, 4))
    _close(srv, c)
    return seen


def test_communicator_geo_matches_jax():
    for got, want in zip(_geo_run(T), _geo_run(J)):
        np.testing.assert_array_equal(got, want)


def test_communicator_async_merges_and_pulls():
    srv, port = _serve(T, lambda s: s.create_dense_table(0, 8, 0.1, "sgd"))
    c = T.PSClient(port=port)
    c.set_dense(0, np.ones(8, np.float32))
    comm = T.Communicator(c, mode="async", send_interval_s=0.02)
    comm.register_dense(0, 8)
    np.testing.assert_array_equal(comm.recv(0), 1.0)  # the first pull
    comm.start()
    comm.send(0, np.ones(8, np.float32))
    comm.send(0, torch.ones(8))
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and \
            abs(float(comm.recv(0)[0]) - 0.8) > 1e-6:
        time.sleep(0.02)
    comm.stop()
    np.testing.assert_allclose(c.pull_dense(0, 8), 0.8, rtol=1e-6)
    np.testing.assert_allclose(comm.recv(0), 0.8, rtol=1e-6)
    _close(srv, c)


def test_heter_service_round_trip():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([1, 2], np.int64), np.float64(3.5)]
    assert T._enc_arrays("sec", arrays) == J._enc_arrays("sec", arrays)
    tag, back = T._dec_arrays(J._enc_arrays("sec", arrays))
    assert tag == "sec"
    for a, b in zip(arrays, back):
        np.testing.assert_array_equal(a, b)
    srv = T.HeterServer()
    srv.register("dense_fwd",
                 lambda x, w: torch.from_numpy(x) @ torch.from_numpy(w) + 1)
    port = srv.start()
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    w = np.random.RandomState(1).rand(4, 2).astype(np.float32)
    want = (torch.from_numpy(x) @ torch.from_numpy(w) + 1).numpy()
    for cli in (T.HeterClient(port=port), J.HeterClient(port=port)):
        try:
            np.testing.assert_array_equal(cli.run("dense_fwd", x, w), want)
            with pytest.raises(RuntimeError, match="missing"):
                cli.run("missing", x)
        finally:
            cli.close()
    srv.stop()


def test_fleet_server_and_trainer_roles(monkeypatch):
    from paddle_tpu_torch.distributed import parallel as par
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.distributed.fleet.base import Fleet

    monkeypatch.setenv("PADDLE_DEVICE", "cpu")
    # two servers: each holds its block of the global dense size
    ports = []
    servers = []
    for i in range(2):
        monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                           "127.0.0.1:1,127.0.0.1:2")
        monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", f"127.0.0.1:{i + 1}")
        f = Fleet()
        f.init(is_collective=False)
        assert f._role_maker.is_server() and f._hcg is None
        assert f._role_maker.server_index() == i
        ports.append(f.init_server(tables={0: ("dense", 7, 0.1, "sgd"),
                                           1: ("sparse", 2, 0.5)},
                                   port=0, n_trainers=1))
        servers.append(f)
    assert par._dist() is None  # no process group in parameter-server mode
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                       ",".join(f"127.0.0.1:{p}" for p in ports))
    st = DistributedStrategy()
    st.a_sync = True
    st.a_sync_configs = {"k_steps": 2}
    tr = Fleet()
    tr.init(strategy=st)
    assert tr._role_maker.is_worker() and not tr._role_maker.is_server()
    client = tr.init_worker()
    assert isinstance(client, T.ShardedPSClient)
    assert tr._ps_communicator.mode == "geo"
    assert tr._ps_communicator.k_steps == 2
    client.set_dense(0, np.zeros(7, np.float32))
    client.push_dense_grad(0, np.ones(7, np.float32))
    np.testing.assert_array_equal(client.pull_dense(0, 7),
                                  np.full(7, -0.1, np.float32))
    blk = T.PSClient(port=ports[1])
    assert blk.pull_dense(0, 3).shape == (3,)  # server 1 holds 3 of 7
    blk.close()
    # run_server returns once a trainer stops the server
    released = []
    th = threading.Thread(target=lambda: (servers[0].run_server(),
                                          released.append(True)))
    th.start()
    client.clients[0].stop_server()
    th.join(timeout=10)
    assert released == [True]
    tr.stop_worker()
    for f in servers:
        f.stop_server()
    # the sync mode: a trainer of a non-a_sync strategy
    srv, port = _serve(T, lambda s: s.create_dense_table(0, 2, 0.1))
    sync = Fleet()
    sync.init(is_collective=False)
    sync.init_worker(endpoint=f"127.0.0.1:{port}")
    assert sync._ps_communicator.mode == "sync"
    sync.stop_worker()
    srv.stop()
