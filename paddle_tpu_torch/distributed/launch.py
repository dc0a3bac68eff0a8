"""Distributed launch CLI (counterpart: paddle_tpu/distributed/
launch.py, the same arguments).

Builds the endpoint model from the arguments, starts one process a
rank of this node with its ``PADDLE_*`` environment, and watches them:
the first that fails has every other terminated (SIGTERM, then SIGKILL
at exit).  With ``--servers`` (parameter-server mode) it starts this
node's servers (``TRAINING_ROLE=PSERVER``, ``PADDLE_PORT``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_PSERVERS_IP_PORT_LIST``) and then
its workers (``--workers``, else ``nproc_per_node`` on loopback), as
the JAX package does; they join no process group.

Usage:
    python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
        [--servers ip:port,...] [--workers ip:port,...]
        [--log_dir dir] script.py [script args...]

Collective ranks also get ``PADDLE_MASTER`` (the first trainer endpoint,
where `init_parallel_env` meets; an inherited one is kept),
``PADDLE_LOCAL_SIZE`` (ranks on this node, for the backend rule) and
``FLAGS_selected_gpus`` (the rank's card, ``rank % nproc_per_node``).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["launch", "main", "get_cluster_from_args"]


def get_cluster_from_args(args) -> dict:
    """Build the {trainers, servers} endpoint model (reference
    `launch_utils.get_cluster_from_args`)."""
    ips = (args.ips or "127.0.0.1").split(",")
    n = args.nproc_per_node
    base = args.start_port
    trainers = [f"{ip}:{base + i}" for ip in ips for i in range(n)]
    servers = [e for e in (args.servers or "").split(",") if e]
    workers = [e for e in (args.workers or "").split(",") if e]
    return {"trainers": trainers, "servers": servers, "workers": workers}


class _Proc:
    def __init__(self, popen, rank, log_fn, log_f):
        self.proc = popen
        self.rank = rank
        self.log_fn = log_fn
        self.log_f = log_f


def _spawn(cmd: List[str], env: dict, log_dir: Optional[str], tag: str,
           rank: int) -> _Proc:
    log_fn, log_f = None, None
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        log_fn = os.path.join(log_dir, f"{tag}.{rank}.log")
        log_f = open(log_fn, "w")
    p = subprocess.Popen(cmd, env=env, stdout=log_f or None,
                         stderr=subprocess.STDOUT if log_f else None)
    return _Proc(p, rank, log_fn, log_f)


def launch(training_script: str, training_script_args: List[str],
           nproc_per_node: int = 1, servers: str = "", workers: str = "",
           ips: str = "127.0.0.1", start_port: int = 6070,
           log_dir: Optional[str] = None, env_extra: Optional[dict] = None,
           node_rank: Optional[int] = None):
    """Programmatic entry.  Returns the list of exit codes for the
    processes spawned ON THIS NODE:
    with a multi-node `ips` list, each node runs this same command and
    spawns only its own slice of ranks (`node_rank` defaults from
    PADDLE_NODE_RANK, mirroring the reference's pod-by-current-ip filter).
    """
    ns = argparse.Namespace(nproc_per_node=nproc_per_node, servers=servers,
                            workers=workers, ips=ips, start_port=start_port)
    cluster = get_cluster_from_args(ns)
    procs: List[_Proc] = []
    if node_rank is None:
        node_rank = int(os.environ.get("PADDLE_NODE_RANK", "0"))
    node_ips = (ips or "127.0.0.1").split(",")
    if not 0 <= node_rank < len(node_ips):
        raise ValueError(f"node_rank {node_rank} out of range for ips {ips}")
    node_ip = node_ips[node_rank]

    def _is_local(endpoint: str) -> bool:
        return endpoint.rsplit(":", 1)[0] == node_ip

    def base_env():
        e = dict(os.environ)
        e.update(env_extra or {})
        return e

    try:
        if cluster["servers"]:
            # parameter-server mode: this node's servers, then its workers
            for i, ep in enumerate(cluster["servers"]):
                if not _is_local(ep):
                    continue
                env = base_env()
                env.update({
                    "TRAINING_ROLE": "PSERVER",
                    "PADDLE_PORT": ep.rsplit(":", 1)[1],
                    "PADDLE_CURRENT_ENDPOINT": ep,
                    "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(
                        cluster["servers"]),
                    "PADDLE_TRAINERS_NUM": str(
                        len(cluster["workers"]) or nproc_per_node),
                })
                procs.append(_spawn(
                    [sys.executable, "-u", training_script,
                     *training_script_args], env, log_dir, "serverlog", i))
            worker_eps = cluster["workers"] or [
                f"127.0.0.1:{start_port + 1000 + i}"
                for i in range(nproc_per_node)]
            for i, wep in enumerate(worker_eps):
                if not _is_local(wep):
                    continue
                env = base_env()
                env.update({
                    "TRAINING_ROLE": "TRAINER",
                    "PADDLE_TRAINER_ID": str(i),
                    "PADDLE_TRAINERS_NUM": str(len(worker_eps)),
                    "PADDLE_CURRENT_ENDPOINT": wep,
                    "PADDLE_TRAINER_ENDPOINTS": ",".join(worker_eps),
                    "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(
                        cluster["servers"]),
                })
                procs.append(_spawn(
                    [sys.executable, "-u", training_script,
                     *training_script_args], env, log_dir, "workerlog", i))
        eps = [] if cluster["servers"] else cluster["trainers"]
        for i, ep in enumerate(eps):
            if not _is_local(ep):
                continue
            env = base_env()
            env.setdefault("PADDLE_MASTER", eps[0])
            env.update({
                "TRAINING_ROLE": "TRAINER",
                "PADDLE_TRAINER_ID": str(i),
                "PADDLE_TRAINERS_NUM": str(len(eps)),
                "PADDLE_LOCAL_SIZE": str(nproc_per_node),
                "PADDLE_CURRENT_ENDPOINT": ep,
                "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
                "FLAGS_selected_gpus": str(i % nproc_per_node),
            })
            procs.append(_spawn(
                [sys.executable, "-u", training_script,
                 *training_script_args], env, log_dir, "workerlog", i))

        if not procs:
            raise RuntimeError(
                f"no server/worker/trainer endpoint matched this node's ip "
                f"{node_ip!r} (node_rank {node_rank} of ips {ips!r}); "
                "check --ips/--node_rank against your endpoint lists")
        # watchdog: any child failing aborts the job (reference
        # `watch_local_trainers` / TrainerProc handling)
        codes = [None] * len(procs)
        while any(c is None for c in codes):
            time.sleep(0.2)
            for idx, p in enumerate(procs):
                if codes[idx] is None:
                    rc = p.proc.poll()
                    if rc is not None:
                        codes[idx] = rc
                        if rc != 0:
                            for q in procs:
                                if q.proc.poll() is None:
                                    q.proc.send_signal(signal.SIGTERM)
        return codes
    finally:
        for p in procs:
            if p.proc.poll() is None:
                p.proc.kill()
            if p.log_f:
                p.log_f.close()


def main(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nproc_per_node", type=int,
                        default=int(os.environ.get("PADDLE_NPROC", "1")))
    parser.add_argument("--ips", type=str, default="127.0.0.1")
    parser.add_argument("--servers", type=str, default="")
    parser.add_argument("--workers", type=str, default="")
    parser.add_argument("--start_port", type=int, default=6070)
    parser.add_argument("--node_rank", type=int, default=None)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    codes = launch(args.training_script, args.training_script_args,
                   nproc_per_node=args.nproc_per_node, servers=args.servers,
                   workers=args.workers, ips=args.ips,
                   start_port=args.start_port, log_dir=args.log_dir,
                   node_rank=args.node_rank)
    bad = [c for c in codes if c]
    sys.exit(bad[0] if bad else 0)


if __name__ == "__main__":
    main()
