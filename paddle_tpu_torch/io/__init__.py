"""paddle.io for the port (counterpart of paddle_tpu/io/__init__.py:22-382):
datasets, samplers, `BatchSampler`, `DistributedBatchSampler`,
`default_collate_fn` and `DataLoader` with its thread prefetch.

Host-side numpy, as in the reference; the index streams are the
reference's: `RandomSampler`, `SubsetRandomSampler` and
`WeightedRandomSampler` draw from numpy's global generator, and
`DistributedBatchSampler` permutes with `np.random.RandomState(epoch)`,
pads to a multiple of the world and gives each rank its contiguous slice.
Its rank and world come from the port's `distributed` (the joined world,
else the launcher's variables). `random_split` draws its permutation from
an explicit `torch.Generator` (the reference draws from `jax.random`).

Batches are torch tensors: `default_collate_fn` stacks samples (tensors,
numpy arrays, ints as int64, floats as float32, lists, tuples and dicts
recursively), and `DataLoader` moves each batch to the device the port
resolves: the card by default, `places` (or 'cpu') when the caller names
one.
"""
from __future__ import annotations

import itertools
import math
import queue
import threading

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "ComposeDataset", "ChainDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "default_collate_fn", "DataLoader",
           "get_worker_info"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Sample i is (t[i] for t in tensors)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        for i, c in enumerate(self.cum):
            if idx < c:
                prev = self.cum[i - 1] if i else 0
                return self.datasets[i][idx - prev]
        raise IndexError(idx)


class ComposeDataset(Dataset):
    """Sample i is the flattened concatenation of each dataset's sample
    i."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("datasets must be non-empty")
        if len({len(d) for d in self.datasets}) != 1:
            raise ValueError("all datasets must have the same length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, (list, tuple)):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


def random_split(dataset, lengths, generator=None):
    """`Subset`s of the given lengths (or fractions) over one permutation
    drawn from `generator` (a `torch.Generator`; PyTorch's default one
    when None)."""
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths):
        lengths = [int(math.floor(total * n)) for n in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(total, generator=generator).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


# ------------------------------------------------------------------ samplers
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


class SubsetRandomSampler(Sampler):
    """A random permutation of a fixed index subset."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = np.random.randint(0, n, size=self.num_samples)
        else:
            idx = np.random.permutation(n)[:self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


def _batches(indices, batch_size, drop_last):
    batch = []
    for idx in indices:
        batch.append(idx)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch and not drop_last:
        yield batch


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        return _batches(self.sampler, self.batch_size, self.drop_last)

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """This rank's batches under Paddle's epoch / seed contract:
    `np.random.RandomState(epoch)` permutes the global index list (when
    `shuffle`), the list is padded to a multiple of the world from its
    start, and each rank takes its contiguous slice. `num_replicas` /
    `rank` default to the port's world (`distributed.env`)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import env

        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nranks = (env.get_world_size() if num_replicas is None
                       else num_replicas)
        self.local_rank = env.get_rank() if rank is None else rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices = indices.tolist()
        indices += indices[:(self.total_size - n)]
        local = indices[self.local_rank * self.num_samples:
                        (self.local_rank + 1) * self.num_samples]
        return _batches(local, self.batch_size, self.drop_last)

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ---------------------------------------------------------------- collation
def default_collate_fn(batch):
    """A list of samples as one batch of torch tensors (see the module
    docstring)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (bool, np.bool_)):
        return torch.tensor(batch, dtype=torch.bool)
    if isinstance(sample, (int, np.integer)):
        return torch.tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    raise TypeError(f"cannot collate batch of {type(sample)}")


def _to_device(batch, dev: torch.device):
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(b, dev) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, dev) for k, v in batch.items()}
    return batch


class DataLoader:
    """Batches of `dataset`, from `batch_sampler` (else a `BatchSampler`
    of `batch_size`, `shuffle`, `drop_last`), collated by `collate_fn` and
    moved to `places` (the port's default device when None; a list takes
    its first). With `num_workers > 0` a thread prefetches up to
    `prefetch_factor * num_workers` batches."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        if isinstance(places, (list, tuple)):
            places = places[0]
        self.device = resolve_device(places)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None or batch_size is None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (len(batch) < self.batch_size
                                 and self.drop_last):
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        if self.num_workers <= 0:
            for b in self._iter_batches():
                yield _to_device(b, self.device)
            return
        q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch_factor * max(self.num_workers, 1))
        sentinel = object()
        failed = []

        def producer():
            try:
                for b in self._iter_batches():
                    q.put(b)
            except BaseException as e:      # handed to the consumer
                failed.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield _to_device(item, self.device)
        t.join()
        if failed:
            raise failed[0]


def get_worker_info():
    return None
