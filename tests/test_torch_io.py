"""The port's io (paddle_tpu_torch.io) against the JAX package's
(paddle_tpu.io): the samplers' index streams under the same numpy seed,
DistributedBatchSampler (shuffle on and off, padding, set_epoch, drop_last)
rank by rank, the datasets, default_collate_fn and DataLoader's batches
(with and without its prefetch thread), value for value."""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as pio


def _make(mod):
    class RangeDataset(mod.Dataset):
        def __init__(self, n):
            self.n = n

        def __getitem__(self, i):
            return (np.float32([i, i * 0.5]), np.int64(i % 3))

        def __len__(self):
            return self.n

    class CountStream(mod.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            for i in range(self.n):
                yield np.float32([i])

    return RangeDataset, CountStream


PRange, PStream = _make(pio)
JRange, JStream = _make(jio)


def _np(batch):
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch.numpy() if hasattr(batch, "numpy") else batch)


def _same(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        # the same kind; the JAX package's integers are int32 without x64
        assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,world,bs,shuffle,drop_last", [
    (10, 2, 2, False, False), (10, 3, 2, False, False),
    (10, 3, 2, True, False), (17, 4, 3, True, True), (16, 4, 4, True, False),
])
def test_distributed_batch_sampler_streams(n, world, bs, shuffle,
                                           drop_last):
    for rank in range(world):
        p = pio.DistributedBatchSampler(PRange(n), bs, num_replicas=world,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        j = jio.DistributedBatchSampler(JRange(n), bs, num_replicas=world,
                                        rank=rank, shuffle=shuffle,
                                        drop_last=drop_last)
        for epoch in (0, 1, 7):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j)
            assert len(p) == len(j)


def test_distributed_batch_sampler_pads_and_reads_the_world(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    s = pio.DistributedBatchSampler(PRange(10), 2)
    assert (s.local_rank, s.nranks) == (2, 3)
    # 10 padded to 12 from the start: rank 2 takes [8, 9, 0, 1]
    assert list(s) == [[8, 9], [0, 1]]


@pytest.mark.parametrize("kind", ["sequence", "random", "subset", "weighted",
                                  "batch", "batch_shuffle"])
def test_sampler_streams_match_under_one_numpy_seed(kind):
    def make(mod, rng_ds):
        if kind == "sequence":
            return mod.SequenceSampler(rng_ds(7))
        if kind == "random":
            return mod.RandomSampler(rng_ds(9))
        if kind == "subset":
            return mod.SubsetRandomSampler([3, 1, 4, 1, 5])
        if kind == "weighted":
            return mod.WeightedRandomSampler([0.1, 0.2, 0.7], 12)
        if kind == "batch":
            return mod.BatchSampler(rng_ds(11), batch_size=4, drop_last=False)
        return mod.BatchSampler(rng_ds(11), shuffle=True, batch_size=3,
                                drop_last=True)

    np.random.seed(123)
    got = list(make(pio, PRange))
    np.random.seed(123)
    want = list(make(jio, JRange))
    assert got == want


def test_datasets():
    ds = pio.TensorDataset([torch.arange(10), torch.arange(10) * 2])
    a, b = ds[3]
    assert int(a) == 3 and int(b) == 6 and len(ds) == 10
    sub = pio.Subset(PRange(10), [0, 5])
    assert len(sub) == 2 and sub[1][1] == 2
    cat = pio.ConcatDataset([PRange(3), PRange(4)])
    assert len(cat) == 7 and cat[5][0][0] == 2
    jcat = jio.ConcatDataset([JRange(3), JRange(4)])
    assert [float(cat[i][0][1]) for i in range(7)] == \
        [float(jcat[i][0][1]) for i in range(7)]
    comp = pio.ComposeDataset([PRange(4), PRange(4)])
    assert len(comp[2]) == 4
    assert [x[0] for x in pio.ChainDataset([PStream(2), PStream(1)])] == \
        [0.0, 1.0, 0.0]
    with pytest.raises(ValueError):
        pio.ComposeDataset([PRange(2), PRange(3)])


def test_random_split_draws_from_the_generator():
    def split(seed):
        return [s.indices for s in pio.random_split(
            PRange(10), [7, 3], generator=torch.Generator().manual_seed(
                seed))]

    a, b = split(1)
    assert sorted(a + b) == list(range(10)) and len(a) == 7
    assert split(1) == [a, b] and split(2) != [a, b]
    assert [len(s) for s in pio.random_split(PRange(10), [0.5, 0.5])] \
        == [5, 5]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match(workers, shuffle):
    np.random.seed(5)
    got = [_np(b) for b in pio.DataLoader(
        PRange(10), batch_size=4, shuffle=shuffle, num_workers=workers,
        places="cpu")]
    np.random.seed(5)
    want = [_np(b) for b in jio.DataLoader(
        JRange(10), batch_size=4, shuffle=shuffle, num_workers=workers)]
    _same(got, want)


def test_dataloader_over_a_distributed_sampler_and_streams():
    s_p = pio.DistributedBatchSampler(PRange(10), 3, num_replicas=2,
                                      rank=1, shuffle=True)
    s_j = jio.DistributedBatchSampler(JRange(10), 3, num_replicas=2,
                                      rank=1, shuffle=True)
    _same([_np(b) for b in pio.DataLoader(PRange(10), batch_sampler=s_p,
                                          places="cpu")],
          [_np(b) for b in jio.DataLoader(JRange(10), batch_sampler=s_j)])
    _same([_np(b) for b in pio.DataLoader(PStream(7), batch_size=3,
                                          drop_last=True, places="cpu")],
          [_np(b) for b in jio.DataLoader(JStream(7), batch_size=3,
                                          drop_last=True)])
    dl = pio.DataLoader(PRange(5), batch_size=None, places="cpu")
    assert len(list(dl)) == 5


def test_collate_forms():
    batch = [{"a": torch.ones(2) * i, "b": i, "c": float(i) / 2,
              "d": np.int32(i)} for i in range(3)]
    got = pio.default_collate_fn(batch)
    assert got["a"].shape == (3, 2) and got["b"].dtype == torch.int64
    assert got["c"].dtype == torch.float32 and got["d"].dtype == torch.int64
    with pytest.raises(TypeError):
        pio.default_collate_fn([object()])


def test_dataloader_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pio.DataLoader(PRange(4), batch_size=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            pio.DataLoader(PRange(4), batch_size=2)


def test_a_failing_dataset_raises_through_the_prefetch_thread():
    class Bad(pio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise IndexError("bad sample")
            return np.float32([i])

    with pytest.raises(IndexError, match="bad sample"):
        list(pio.DataLoader(Bad(), batch_size=1, num_workers=1,
                            places="cpu"))
