"""``paddle.io``: datasets, samplers and the in-process DataLoader
(counterpart: paddle_tpu/io/__init__.py).

Host-side Python copied from the JAX package: the datasets, `random_split`,
the samplers (`RandomSampler` and `random_split` shuffle with numpy's
global RNG, so one ``np.random.seed`` gives both packages the same order),
`DistributedBatchSampler` (rank and world size from torch.distributed
when it is initialized, else 0 and 1), `default_collate_fn` (numpy
batches) and `DataLoader`, which moves each collated batch to its
device (``places``; default: the card) as tensors.  Worker processes
(``num_workers > 0``) come with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import to_device
from ..core.tensor import from_numpy

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "ChainDataset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader"]


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = [t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cumulative, idx, side="right"))
        prev = 0 if d == 0 else int(self.cumulative[d - 1])
        return self.datasets[d][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


def random_split(dataset, lengths, generator=None):
    idx = np.random.permutation(len(dataset))
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, idx[start:start + ln].tolist()))
        start += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """reference `fluid/dataloader/batch_sampler.py` DistributedBatchSampler."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else _world_size()
        self.local_rank = rank if rank is not None else _rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        import math

        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return np.stack([s.detach().cpu().numpy() for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.asarray(batch)


class DataLoader:
    """``paddle.io.DataLoader`` in one process: batches of
    ``batch_sampler`` (default: a `BatchSampler` over ``batch_size``,
    ``shuffle``, ``drop_last``), collated by ``collate_fn`` and moved to
    ``places`` (a device or Place; default: the card) as tensors.
    ``num_workers > 0`` raises NotImplementedError."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, multiprocess_mode="process"):
        if num_workers > 0:
            raise NotImplementedError(
                f"DataLoader(num_workers={num_workers}) is not ported yet: "
                "worker processes land with the io worker slice of "
                "paddle_tpu_torch; use num_workers=0")
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = 0
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = to_device(places)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _to_tensors(self, batch):
        if isinstance(batch, (tuple, list)):
            return tuple(self._to_tensors(b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._to_tensors(v) for k, v in batch.items()}
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        return from_numpy(np.asarray(batch)).to(self.device)

    def __iter__(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self._to_tensors(self.collate_fn(batch))
                    batch = []
            if batch and not self.drop_last:
                yield self._to_tensors(self.collate_fn(batch))
            return
        for indices in self.batch_sampler:
            yield self._to_tensors(self._fetch(indices))
