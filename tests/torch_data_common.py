"""Datasets of tests/test_torch_elastic_data.py's DataLoader checks, in a
module of their own: a spawned worker process unpickles them by
importing this file, which imports numpy alone (neither package)."""
import os
import time

import numpy as np


class BigDs:
    """Samples large enough for the shared-memory transport (>= 4 KiB);
    each carries the process that made it."""

    def __getitem__(self, i):
        return (np.full((64, 64), i, np.float32), np.int64(i),
                np.int64(os.getpid()))

    def __len__(self):
        return 12


class CrashDs:
    """Raises on sample 5."""

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("poison sample")
        return np.float32([i]), np.int64(i)

    def __len__(self):
        return 8


class SlowDs:
    """Sample 3 takes 4 s."""

    def __getitem__(self, i):
        if i == 3:
            time.sleep(4)
        return np.float32([i])

    def __len__(self):
        return 8


def check_worker(worker_id):
    """A ``worker_init_fn``: the worker sees its own info and no card."""
    from paddle_tpu_torch.io import get_worker_info

    info = get_worker_info()
    assert info is not None and info.id == worker_id
    assert info.num_workers == 2 and isinstance(info.dataset, BigDs)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == ""
