"""The fleet datasets (counterpart: paddle_tpu/distributed/fleet/
dataset.py, host Python copied).

`QueueDataset` streams, `InMemoryDataset` loads (``load_into_memory``,
``preload_into_memory``) and shuffles (``local_shuffle``, and
``global_shuffle``, which is the seeded local shuffle: every trainer
reads the whole stream, as in the JAX package) files in the MultiSlot
format: a line an instance, and for each slot of ``use_var``, in order,
``<num> v1 ... vnum`` (uint64 or float by the slot's dtype).  Files are
parsed by a pool of ``thread_num`` threads, each through
``pipe_command`` (fed on stdin) when it is not ``cat``.  ``iter_batches``
yields ``{name: padded numpy array, name + ".lod": lengths}`` a batch
(the final partial batch too); a slot whose variable is rank-1 collapses
to ``[B]``, and `InMemoryDataset` pads every ragged slot to its widest
instance so the shapes stay fixed over the epoch.  `DatasetFactory`
makes either.  ``Executor.train_from_dataset`` belongs to static
training, slice 4b (ROADMAP.md Queue 1, item 4b).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset",
           "DatasetFactory"]


def _is_int_dtype(dtype: str) -> bool:
    return "int" in str(dtype)


class DatasetBase:
    """``batch_size``, ``thread_num`` and ``use_var`` with a list of
    MultiSlot files."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.use_vars = []
        self.pipe_command = "cat"
        self.input_type = 0

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command="cat", input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self._set_batch_size(batch_size)
        self._set_thread(thread_num)
        if use_var is not None:
            self._set_use_var(use_var)
        self._set_pipe_command(pipe_command)
        self.input_type = input_type

    def _set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def _set_thread(self, thread_num):
        self.thread_num = max(1, int(thread_num))

    def _set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def _set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def get_filelist(self):
        return list(self.filelist)

    # -- parsing ------------------------------------------------------------
    def _slot_specs(self):
        specs = []
        for v in self.use_vars:
            name = getattr(v, "name", str(v))
            dtype = str(getattr(v, "dtype", "float32"))
            shape = getattr(v, "shape", None)
            # rank-1 feed var ([-1] / [N]) => scalar-per-instance slot,
            # batched as [B]; anything else stays [B, width]
            rank1 = (len(shape) == 1) if shape else None
            specs.append((name, _is_int_dtype(dtype), rank1))
        return specs

    def _read_lines(self, path: str):
        if self.pipe_command and self.pipe_command != "cat":
            # every file is piped through pipe_command (e.g. "zcat" for
            # gzip parts), a user-supplied shell pipeline; the file name
            # is never put into the shell: the file is fed on stdin
            import subprocess

            with open(path, "rb") as fin:
                r = subprocess.run(self.pipe_command, shell=True,
                                   stdin=fin, capture_output=True,
                                   text=True, check=True)
            return r.stdout.splitlines()
        with open(path, "r") as f:
            return f.read().splitlines()

    def _parse_file(self, path: str) -> List[List[np.ndarray]]:
        """One instance a line; per slot ``<num> v1..vnum`` in
        ``use_var``'s order."""
        specs = self._slot_specs()
        instances = []
        for line in self._read_lines(path):
            parts = line.split()
            if not parts:
                continue
            pos = 0
            inst = []
            for _, is_int, _rank1 in specs:
                num = int(parts[pos])
                pos += 1
                vals = parts[pos:pos + num]
                pos += num
                if is_int:
                    inst.append(np.asarray([int(v) for v in vals],
                                           np.int64))
                else:
                    inst.append(np.asarray([float(v) for v in vals],
                                           np.float32))
            instances.append(inst)
        return instances

    def _parse_all(self) -> List[List[np.ndarray]]:
        if not self.filelist:
            return []
        with ThreadPoolExecutor(max_workers=self.thread_num) as pool:
            chunks = list(pool.map(self._parse_file, self.filelist))
        return [inst for chunk in chunks for inst in chunk]

    def _batches(self, instances, fixed_widths: Optional[List[int]] = None):
        """Yield {name: padded array, name+'.lod': lengths} per batch,
        including the final partial batch.  `fixed_widths` pads each
        ragged slot to a constant width so batch shapes are stable
        across the epoch; without it the width is the batch max.  A slot whose
        use_var is rank-1 collapses to [B] (the scalar-label case)."""
        specs = self._slot_specs()
        bs = self.batch_size
        for i in range(0, len(instances), bs):
            group = instances[i:i + bs]
            out: Dict[str, np.ndarray] = {}
            for s, (name, is_int, rank1) in enumerate(specs):
                vals = [inst[s] for inst in group]
                lens = np.asarray([len(v) for v in vals], np.int64)
                width = fixed_widths[s] if fixed_widths else \
                    (int(lens.max()) if len(lens) else 0)
                dt = np.int64 if is_int else np.float32
                pad = np.zeros((len(group), width), dt)
                for r, v in enumerate(vals):
                    pad[r, :len(v)] = v
                squeeze = rank1 if rank1 is not None else width == 1
                if squeeze and width == 1:
                    pad = pad[:, 0]
                out[name] = pad
                out[name + ".lod"] = lens
            yield out

    def _widths_of(self, instances) -> List[int]:
        specs = self._slot_specs()
        widths = [1] * len(specs)
        for inst in instances:
            for s in range(len(specs)):
                widths[s] = max(widths[s], len(inst[s]))
        return widths

    def _desc(self):
        specs = self._slot_specs()
        return "\n".join(
            f"slot {n} {'uint64' if i else 'float'}" for n, i, _ in specs)


class QueueDataset(DatasetBase):
    """Streaming dataset: parses and yields batches file by file,
    nothing held in memory."""

    def iter_batches(self):
        for path in self.filelist:
            yield from self._batches(self._parse_file(path))


class InMemoryDataset(DatasetBase):
    """Loaded into memory and shuffled (locally or globally) before
    training."""

    def __init__(self):
        super().__init__()
        self._memory: List = []
        self._seed = 0

    def load_into_memory(self, is_shuffle=False):
        self._memory = self._parse_all()
        if is_shuffle:
            self.local_shuffle()

    def preload_into_memory(self, thread_num=None):
        if thread_num:
            self._set_thread(thread_num)
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        rng = np.random.RandomState(self._seed)
        rng.shuffle(self._memory)
        self._seed += 1

    def global_shuffle(self, fleet=None, thread_num=12):
        # every trainer reads the whole stream, so the seeded local
        # shuffle is the global shuffle (as in the JAX package)
        self.local_shuffle()

    def release_memory(self):
        self._memory = []

    def get_memory_data_size(self, fleet=None):
        return len(self._memory)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._memory)

    def iter_batches(self):
        # pad ragged slots to the global max so every batch has the same
        # shapes
        yield from self._batches(self._memory,
                                 fixed_widths=self._widths_of(self._memory))


class DatasetFactory:
    """Makes a dataset by its class name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")
