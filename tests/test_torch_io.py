"""The port's `io` against the reference's `paddle_tpu.io` on the CPU.

- samplers: SequenceSampler / BatchSampler batches, BucketSampler and
  DistributedBatchSampler orders (shuffles included: both packages draw
  them from numpy `RandomState`) equal the reference's exactly; the
  torch-generator samplers repeat themselves from one seed;
- `padded_collate` and `default_collate_fn` give the reference's values,
  shapes and (32-bit) dtypes;
- the DataLoader with 0 workers, 2 worker processes, the thread path
  (use_shared_memory=False, or a dataset that cannot be pickled) and the
  device-prefetch stage (device="cpu") yields the reference loader's
  batches in order; a worker's exception keeps its type; worker_init_fn
  and get_worker_info run in the workers;
- a mid-epoch `state_dict()` resumes on the exact next batch (shuffled,
  prefetched, with workers), and checkpointed through
  `distributed.checkpoint` too;
- the `dataloader.next` and `dataloader.hang` fault points fire;
- no worker process outlives its iterator (exhausted, failed, abandoned),
  and workers run with SIGTERM and SIGUSR1 at SIG_DFL.
"""

import gc
import multiprocessing as mp
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.framework import core as tcore


@pytest.fixture(autouse=True)
def _neutral():
    """Restore both packages' generators and the fault flags."""
    jstate, tstate = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(jstate)
    torch.set_rng_state(tstate)
    tinj.disarm()
    tcore.set_flags({"FLAGS_fault_hang_sec": 3600.0})


class _DS(tio.Dataset):
    """Reference-free dataset: sample i is (float32 [3] of i, int64 i)."""

    def __init__(self, n=40):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), np.int64(i)


class _JDS(jio.Dataset):
    def __init__(self, n=40):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), np.int64(i)


class _Bad(_DS):
    def __getitem__(self, i):
        if i == 7:
            raise KeyError("poison sample")
        return super().__getitem__(i)


class _Unpicklable(_DS):
    def __init__(self, n=16):
        super().__init__(n)
        self.lock = threading.Lock()


class _Sig(_DS):
    def __getitem__(self, i):
        ok = all(signal.getsignal(s) == signal.SIG_DFL
                 for s in (signal.SIGTERM, signal.SIGUSR1))
        return np.int64(ok), np.int64(i)


class _Who(_DS):
    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.int64(-1 if info is None else info.id), np.int64(i)


LENGTHS = [5, 9, 13, 17, 21, 25, 29, 31, 8, 16, 24, 32, 7, 15, 23, 31, 3, 11]
BOUNDS = (8, 16, 32)


def _ragged(lengths=LENGTHS, vocab=50, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, (n,)).astype(np.int32), np.int64(i % 3))
            for i, n in enumerate(lengths)]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _children():
    gc.collect()
    return mp.active_children()


# ---------------------------------------------------------------- samplers


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (3, False), (3, True)])
def test_batch_sampler_matches_reference(batch_size, drop_last):
    got = list(tio.BatchSampler(_DS(10), batch_size=batch_size, drop_last=drop_last))
    want = list(jio.BatchSampler(_JDS(10), batch_size=batch_size, drop_last=drop_last))
    assert got == want
    assert len(tio.BatchSampler(_DS(10), batch_size=batch_size,
                                drop_last=drop_last)) == len(want)
    assert list(tio.SequenceSampler(_DS(5))) == list(jio.SequenceSampler(_JDS(5)))


@pytest.mark.parametrize("shuffle,drop_last,pad,seed", [
    (False, False, True, 0), (True, False, True, 0), (True, True, True, 3),
    (True, False, False, 7)])
def test_bucket_sampler_orders_match_reference(shuffle, drop_last, pad, seed):
    rows = _ragged()
    kw = dict(bucket_boundaries=BOUNDS, batch_size=4, shuffle=shuffle,
              drop_last=drop_last, seed=seed, pad_last_batch=pad)
    t, j = tio.BucketSampler(rows, **kw), jio.BucketSampler(rows, **kw)
    for epoch in range(3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        assert list(t) == list(j)
    assert len(t) == len(j)
    assert [t.bucket_of(i) for i in range(len(rows))] == \
        [j.bucket_of(i) for i in range(len(rows))]
    assert t.state_dict() == j.state_dict() == {"epoch": 2}


def test_bucket_sampler_refuses_overlong_samples():
    with pytest.raises(ValueError, match="exceed"):
        tio.BucketSampler(lengths=[4, 100], bucket_boundaries=(8, 16), batch_size=2)
    with pytest.raises(ValueError, match="exceeds"):
        tio.padded_collate((8, 16))([(np.zeros(20, np.int32), np.int64(0))])


@pytest.mark.parametrize("nranks,shuffle,drop_last", [(1, False, False), (2, True, False),
                                                      (3, True, True)])
def test_distributed_batch_sampler_matches_reference(nranks, shuffle, drop_last):
    for rank in range(nranks):
        t = tio.DistributedBatchSampler(_DS(11), 2, num_replicas=nranks, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(_JDS(11), 2, num_replicas=nranks, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in range(2):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


def test_generator_samplers_repeat_from_a_seed():
    def order(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return list(tio.RandomSampler(_DS(20), generator=g, **kw))

    assert order(1) == order(1) != order(2)
    assert sorted(order(1)) == list(range(20))
    draws = order(3, replacement=True, num_samples=50)
    assert len(draws) == 50 and all(0 <= i < 20 for i in draws)
    w = tio.WeightedRandomSampler([0.0, 1.0, 0.0, 3.0], 200,
                                  generator=torch.Generator().manual_seed(0))
    got = list(w)
    assert len(w) == 200 and set(got) == {1, 3} and got.count(3) > got.count(1)
    parts = tio.random_split(_DS(10), [3, 7], generator=torch.Generator().manual_seed(0))
    idx = [p.dataset is not None and p.indices for p in parts]
    assert sorted(idx[0] + idx[1]) == list(range(10)) and len(parts[1]) == 7


def test_datasets_match_reference():
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6, dtype=np.int32)
    t, j = tio.TensorDataset([xs, ys]), jio.TensorDataset([xs, ys])
    assert len(t) == len(j) == 6
    for i in range(6):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(_np(a), _np(b))
    tc = tio.ConcatDataset([tio.Subset(_DS(5), [4, 2]), _DS(3)])
    jc = jio.ConcatDataset([jio.Subset(_JDS(5), [4, 2]), _JDS(3)])
    assert len(tc) == len(jc) == 5
    assert [int(tc[i][1]) for i in range(5)] == [int(jc[i][1]) for i in range(5)]
    assert list(iter(tio.ChainDataset([[1, 2], [3]]))) == \
        list(iter(jio.ChainDataset([[1, 2], [3]]))) == [1, 2, 3]


# ----------------------------------------------------------------- collate


def test_padded_collate_matches_reference():
    rows = _ragged()
    for idx in ([0, 1, 16, 8], [2, 3, 4, 5], [11, 7, 14, 15]):
        got = tio.padded_collate(BOUNDS)([rows[i] for i in idx])
        want = jio.padded_collate(BOUNDS)([rows[i] for i in idx])
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor)
            assert str(g.dtype).split(".")[1] == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), _np(w))


def test_default_collate_matches_reference():
    samples = [(np.full((2, 3), i, np.float64), i, float(i) / 3, np.int64(i))
               for i in range(4)]
    got, want = tio.default_collate_fn(samples), jio.default_collate_fn(samples)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), _np(w))
    dicts = [{"a": np.ones(2, np.float32) * i, "b": i} for i in range(3)]
    got, want = tio.default_collate_fn(dicts), jio.default_collate_fn(dicts)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))
    stacked = tio.default_collate_fn([torch.ones(2) * i for i in range(3)])
    assert torch.equal(stacked, torch.arange(3.0)[:, None].expand(3, 2))


# ------------------------------------------------------------- the loader

MODES = {"in-thread": dict(num_workers=0), "workers": dict(num_workers=2),
         "threads": dict(num_workers=2, use_shared_memory=False),
         "prefetch": dict(num_workers=2, prefetch_to_device=2, device="cpu")}


@pytest.mark.parametrize("mode", MODES)
def test_loader_batches_match_reference(mode):
    got = [[_np(f) for f in b] for b in tio.DataLoader(_DS(22), batch_size=4, **MODES[mode])]
    want = [[_np(f) for f in b] for b in jio.DataLoader(_JDS(22), batch_size=4)]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert _children() == []


def test_unpicklable_dataset_runs_on_threads():
    loader = tio.DataLoader(_Unpicklable(16), batch_size=4, num_workers=2)
    it = iter(loader)
    first = next(it)
    assert _children() == [], "an unpicklable dataset must not fork workers"
    rest = list(it)
    assert [b[1].tolist() for b in [first] + rest] == \
        [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15]]


@pytest.mark.parametrize("mode", MODES)
def test_worker_error_keeps_its_type(mode):
    with pytest.raises(KeyError, match="poison sample"):
        list(tio.DataLoader(_Bad(), batch_size=4, **MODES[mode]))
    assert _children() == []


def test_worker_info_and_init_fn_run_in_the_workers():
    ids = [int(x) for b in tio.DataLoader(_Who(16), batch_size=2, num_workers=2)
           for x in b[0]]
    assert set(ids) <= {0, 1} and ids
    assert tio.get_worker_info() is None
    seen = mp.get_context("fork").Queue()
    list(tio.DataLoader(_DS(8), batch_size=2, num_workers=2,
                        worker_init_fn=lambda wid: seen.put(wid)))
    assert sorted(seen.get(timeout=10) for _ in range(2)) == [0, 1]
    with pytest.raises(ZeroDivisionError):
        list(tio.DataLoader(_DS(8), batch_size=2, num_workers=2,
                            worker_init_fn=lambda wid: 1 / 0))
    assert _children() == []


def test_workers_reset_sigterm_and_sigusr1():
    prev = {s: signal.signal(s, lambda *a: None) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        flags = [int(x) for b in tio.DataLoader(_Sig(8), batch_size=4, num_workers=2)
                 for x in b[0]]
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
    assert flags == [1] * 8


@pytest.mark.parametrize("how", ["exhausted", "error", "abandoned", "closed"])
def test_no_worker_outlives_its_iterator(how):
    if how == "error":
        with pytest.raises(KeyError):
            list(tio.DataLoader(_Bad(400), batch_size=4, num_workers=2))
    elif how == "exhausted":
        assert len(list(tio.DataLoader(_DS(40), batch_size=4, num_workers=2))) == 10
    else:
        it = iter(tio.DataLoader(_DS(400), batch_size=4, num_workers=2,
                                 prefetch_to_device=2, device="cpu"))
        next(it)
        next(it)
        assert len(mp.active_children()) == 2
        if how == "closed":
            it.close()
        del it
    assert _children() == []


@pytest.mark.parametrize("mode", ["in-thread", "workers", "prefetch"])
def test_mid_epoch_resume_is_exactly_once(mode):
    def loader(seed):
        return tio.DataLoader(_DS(24), batch_size=4, shuffle=True,
                              generator=torch.Generator().manual_seed(seed),
                              **MODES[mode])

    full = [b[1].tolist() for b in loader(5)]
    first = loader(5)
    it = iter(first)
    taken = [next(it)[1].tolist() for _ in range(2)]
    state = first.state_dict()
    del it
    assert state["batches_consumed"] == 2 and taken == full[:2]
    resumed = loader(77)  # another seed: the saved state must win
    resumed.set_state_dict(state)
    assert [b[1].tolist() for b in resumed] == full[2:]
    # the next epoch starts afresh, from the generator as the epoch left it
    assert resumed._epoch == 1 and resumed.state_dict()["batches_consumed"] == 0
    assert _children() == []


def test_resume_through_a_committed_checkpoint(tmp_path):
    def loader():
        return tio.DataLoader(_DS(20), batch_size=4, shuffle=True, num_workers=2,
                              generator=torch.Generator().manual_seed(11))

    full = [b[1].tolist() for b in loader()]
    live = loader()
    it = iter(live)
    next(it)
    next(it)
    next(it)
    tckpt.save_checkpoint({"w": torch.ones(2)}, str(tmp_path), step=3, data_loader=live)
    it.close()
    fresh = loader()
    assert tckpt.load_latest({"w": torch.zeros(2)}, str(tmp_path), data_loader=fresh) == 3
    assert [b[1].tolist() for b in fresh] == full[3:]


def test_bucketed_loader_resume_and_shapes():
    rows = _ragged()

    def loader():
        bs = tio.BucketSampler(rows, bucket_boundaries=BOUNDS, batch_size=4,
                               shuffle=True, seed=2)
        return tio.DataLoader(rows, batch_sampler=bs, collate_fn=tio.padded_collate(BOUNDS))

    full = [b for b in loader()]
    assert {b[0].shape[1] for b in full} == set(BOUNDS)
    first = loader()
    it = iter(first)
    next(it)
    state = first.state_dict()
    it.close()
    again = loader()
    again.set_state_dict(state)
    rest = list(again)
    assert len(rest) == len(full) - 1
    for a, b in zip(rest, full[1:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_iterable_dataset_batches_and_skip():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter([np.int64(i) for i in range(10)])

    loader = tio.DataLoader(Stream(), batch_size=3)
    assert [b.tolist() for b in loader] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    loader.set_state_dict({"epoch": 0, "batches_consumed": 2})
    assert [b.tolist() for b in loader] == [[6, 7, 8], [9]]
    with pytest.raises(TypeError):
        len(loader)


@pytest.mark.parametrize("mode", ["in-thread", "workers", "threads"])
def test_dataloader_next_fault_point(mode):
    tinj.arm("dataloader.next:1")
    with pytest.raises(tinj.InjectedFault):
        list(tio.DataLoader(_DS(8), batch_size=2, **MODES[mode]))
    tinj.disarm()
    assert len(list(tio.DataLoader(_DS(8), batch_size=2, **MODES[mode]))) == 4
    assert _children() == []


def test_dataloader_hang_fault_point():
    tcore.set_flags({"FLAGS_fault_hang_sec": 0.05})
    tinj.arm("dataloader.hang:2")
    assert len(list(tio.DataLoader(_DS(8), batch_size=2))) == 4
    assert tinj.hits("dataloader.hang") == 5  # 4 batches and the epoch's end


def test_prefetch_to_device_cpu_stage():
    loader = tio.DataLoader(_DS(24), batch_size=4, prefetch_to_device=True, device="cpu")
    seen = []
    for xb, yb in loader:
        assert xb.device.type == "cpu" and xb.shape == (4, 3)
        np.testing.assert_array_equal(xb.numpy()[:, 0], yb.numpy().astype(np.float32))
        seen.extend(yb.tolist())
    assert seen == list(range(24)) and loader._prefetch_hwm >= 1
    with pytest.raises(KeyError, match="poison"):
        list(tio.DataLoader(_Bad(16), batch_size=4, prefetch_to_device=2, device="cpu"))
