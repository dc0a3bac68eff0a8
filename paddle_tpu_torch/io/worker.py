"""DataLoader worker processes with shared-memory batch transport
(counterpart: paddle_tpu/io/worker.py, host Python copied).

Workers are spawned processes (``spawn``: a forked child of a process
that holds a CUDA context cannot use it) that collate numpy batches and
place each array of 4 KiB or more in a POSIX shared-memory segment
(`multiprocessing.shared_memory`); the parent maps the segment, copies
it out and unlinks it.  A worker's environment has
``CUDA_VISIBLE_DEVICES=""``, so no worker opens the card the trainer
owns (the JAX package pins ``JAX_PLATFORMS=cpu`` there).
"""
from __future__ import annotations

import traceback
from typing import Optional

import numpy as np

_WORKER_INFO = None


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def get_worker_info() -> Optional[WorkerInfo]:
    return _WORKER_INFO


_SHM_MIN_BYTES = 4096  # below this, queue pickling beats a segment


def _pack(obj, shms: list, use_shared_memory: bool):
    """Replace large ndarrays with shared-memory descriptors."""
    if isinstance(obj, tuple):
        return tuple(_pack(o, shms, use_shared_memory) for o in obj)
    if isinstance(obj, list):
        return [_pack(o, shms, use_shared_memory) for o in obj]
    if isinstance(obj, dict):
        return {k: _pack(v, shms, use_shared_memory) for k, v in obj.items()}
    if isinstance(obj, np.ndarray) and use_shared_memory and \
            obj.nbytes >= _SHM_MIN_BYTES:
        from multiprocessing import shared_memory

        seg = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        view = np.ndarray(obj.shape, obj.dtype, buffer=seg.buf)
        view[...] = obj
        shms.append(seg)
        return ("__shm__", seg.name, obj.shape, str(obj.dtype))
    return obj


def _unpack(obj):
    if isinstance(obj, tuple):
        if len(obj) == 4 and obj[0] == "__shm__":
            from multiprocessing import shared_memory

            _, name, shape, dtype = obj
            seg = shared_memory.SharedMemory(name=name)
            try:
                arr = np.ndarray(shape, np.dtype(dtype),
                                 buffer=seg.buf).copy()
            finally:
                seg.close()
                seg.unlink()
            return arr
        return tuple(_unpack(o) for o in obj)
    if isinstance(obj, list):
        return [_unpack(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def _discard_payload(payload):
    """Unlink any shared-memory segments referenced by an unconsumed
    payload (stale generation, error teardown, shutdown drain) — dropped
    descriptors would otherwise leak /dev/shm until reboot."""
    if payload is None:
        return
    try:
        _unpack(payload)  # maps, copies (cheap relative to a leak), unlinks
    except Exception:
        pass


def _worker_loop(dataset, collate_fn, index_queue, result_queue, worker_id,
                 num_workers, use_shared_memory, worker_init_fn, seed):
    """Runs in the spawned child: pull index lists, push packed batches,
    with per-worker seeding and the exception's traceback sent back to
    the parent."""
    global _WORKER_INFO
    import torch

    # one intra-op thread a worker, as torch.utils.data's workers: the
    # workers together already fill the cores (a transform that runs
    # torch ops, such as Resize, would otherwise start a thread a core in
    # every worker)
    torch.set_num_threads(1)
    _WORKER_INFO = WorkerInfo(worker_id, num_workers, dataset)
    np.random.seed((int(seed) + worker_id) % (2 ** 32))
    if worker_init_fn is not None:
        try:
            worker_init_fn(worker_id)
        except Exception:
            result_queue.put((0, None, None, traceback.format_exc()))
            return
    while True:
        item = index_queue.get()
        if item is None:  # sentinel: clean shutdown
            break
        gen, bid, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            shms = []
            payload = _pack(batch, shms, use_shared_memory)
            result_queue.put((gen, bid, payload, None))
            # child closes its mapping; the parent unlinks after copying.
            # Unregister from this process's resource tracker so the
            # child's exit doesn't double-unlink / warn about segments the
            # parent owns now.
            for seg in shms:
                try:
                    from multiprocessing import resource_tracker

                    resource_tracker.unregister(seg._name, "shared_memory")
                except Exception:
                    pass
                seg.close()
        except Exception:
            result_queue.put((gen, bid, None, traceback.format_exc()))
