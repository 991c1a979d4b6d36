"""Datasets, samplers and the DataLoader of the port (counterpart of
`paddle_tpu/io/__init__.py`).

Batches are collated on the host (numpy, then CPU tensors with int64 and
float64 demoted to 32 bits, as the reference's `Tensor` demotes them),
by the consumer's thread (`num_workers=0`), by forked worker processes,
or by a thread when the dataset cannot be pickled or
`use_shared_memory=False`.  `prefetch_to_device=N` adds a stage that
copies the next batches to the card from pinned memory on a side CUDA
stream while the current step runs; the consumer's stream waits on each
batch's event.

Shuffles draw from an explicit `torch.Generator` (`generator=`; torch's
default CPU generator when none is given).  `BucketSampler` and
`DistributedBatchSampler` shuffle with numpy `RandomState(seed + epoch)`
and `RandomState(epoch)`, as the reference does, so their orders equal
the reference's exactly.

Exactly-once resume: `DataLoader.state_dict()` is the epoch, the batches
the CONSUMER has taken this epoch and the shuffle generator's state at
the epoch's start; `set_state_dict()` puts the generator back, so the
resumed epoch draws the same order, and skips the consumed batches at the
index level (they are never fetched again).  Batches sitting in a
prefetch queue are not consumed: they are produced again after a resume.

Workers are forked, as the reference's are (and torch's DataLoader's on
Linux): the dataset and a collate closure such as `padded_collate`'s need
not pickle, and a worker starts in milliseconds.  A worker runs the
dataset, numpy, pickle and CPU torch only, never CUDA.  Worker processes
never outlive their iterator: exhausted, failed or abandoned (closed or
garbage-collected), the iterator stops them, and a worker whose parent
died exits on its own within a second.  Workers reset
SIGTERM and SIGUSR1 to SIG_DFL (a parent's drain or preemption handler
must not run in them) and use one intra-op thread.  A worker's exception
reaches the consumer with its own type, with a note naming the worker
and batch.
"""

from __future__ import annotations

import itertools
import math
import os
import pickle
import queue
import signal
import threading

import numpy as np
import torch

from ..fault import injection as _inj
from ..fault import watchdog as _wd
from ..framework import core as _core

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset", "ConcatDataset",
           "ChainDataset", "random_split", "Sampler", "SequenceSampler",
           "RandomSampler", "WeightedRandomSampler", "BatchSampler", "BucketSampler",
           "padded_collate", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "WorkerInfo", "get_worker_info"]


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


class TensorDataset(Dataset):
    """Rows of equally long tensors or numpy arrays: item i is the tuple
    of every field's row i."""

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
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        for i, c in enumerate(self.cum):
            if idx < c:
                return self.datasets[i][idx - (self.cum[i - 1] if i else 0)]
        raise IndexError(idx)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


def random_split(dataset, lengths, generator=None):
    """Disjoint Subsets of the given lengths over one permutation drawn
    from `generator` (torch's default when None)."""
    n = len(dataset)
    if sum(lengths) != n:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(n, generator=generator).tolist()
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln]))
        off += ln
    return out


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


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
    """A permutation (or, with `replacement`, uniform draws) of the indices
    from `generator` (torch's default CPU generator when None)."""

    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,), generator=self.generator)
        else:
            idx = torch.randperm(n, generator=self.generator)[:self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """`num_samples` indices drawn with probability proportional to
    `weights`, from `generator`."""

    def __init__(self, weights, num_samples, replacement=True, generator=None):
        self.weights = torch.as_tensor(np.asarray(weights, np.float64))
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        idx = torch.multinomial(self.weights, self.num_samples, self.replacement,
                                generator=self.generator)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False, generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
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


class BucketSampler(Sampler):
    """Length-bucketed batch sampler for ragged datasets (reference :193):
    samples are grouped by the smallest `bucket_boundaries` entry >= their
    length and batched within a bucket, so with `padded_collate` every
    batch has one of len(bucket_boundaries) shapes.  The shuffle (within
    each bucket, then across batches) is numpy `RandomState(seed +
    epoch)`, the reference's order exactly.

    lengths: per-sample lengths, or None for len(dataset[i][0]).
    pad_last_batch: a bucket's short tail batch wraps around with indices
    of the same bucket, so every batch is [batch_size, boundary].
    """

    def __init__(self, dataset=None, lengths=None, bucket_boundaries=(64, 128, 256, 512),
                 batch_size=1, shuffle=False, drop_last=False, seed=0,
                 pad_last_batch=True):
        self.pad_last_batch = pad_last_batch
        if lengths is None:
            if dataset is None:
                raise ValueError("BucketSampler needs `dataset` or `lengths`")
            lengths = [len(dataset[i][0]) for i in range(len(dataset))]
        self.lengths = [int(x) for x in lengths]
        self.boundaries = sorted(int(b) for b in bucket_boundaries)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        too_long = [i for i, n in enumerate(self.lengths) if n > self.boundaries[-1]]
        if too_long:
            raise ValueError(
                f"BucketSampler: {len(too_long)} samples exceed the largest "
                f"bucket boundary {self.boundaries[-1]} (first: index "
                f"{too_long[0]}, length {self.lengths[too_long[0]]})")
        self._buckets = {}
        for i, n in enumerate(self.lengths):
            self._buckets.setdefault(self.bucket_of(i), []).append(i)

    def bucket_of(self, idx):
        n = self.lengths[idx]
        return next(bd for bd in self.boundaries if n <= bd)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def state_dict(self):
        return {"epoch": int(self.epoch)}

    def set_state_dict(self, state):
        self.set_epoch(int(state.get("epoch", 0)))

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch) if self.shuffle else None
        batches = []
        for bd in self.boundaries:
            idxs = list(self._buckets.get(bd, []))
            if not idxs:
                continue
            if rng is not None:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i:i + self.batch_size]
                if len(chunk) < self.batch_size:
                    if self.drop_last:
                        continue
                    if self.pad_last_batch:
                        while len(chunk) < self.batch_size:
                            chunk = chunk + idxs[:self.batch_size - len(chunk)]
                batches.append(chunk)
        if rng is not None:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        n = 0
        for idxs in self._buckets.values():
            if self.drop_last:
                n += len(idxs) // self.batch_size
            else:
                n += (len(idxs) + self.batch_size - 1) // self.batch_size
        return n


def padded_collate(bucket_boundaries, ragged_fields=(0,), pad_value=0):
    """Collate-fn factory for BucketSampler batches (reference :283): the
    ragged fields are padded (axis 0) to the smallest boundary >= the
    batch's longest sample, and each sample gets its int32 length
    appended, from which a model builds its padding mask (BERT turns it
    into the flash kernels' segment ids)."""
    boundaries = sorted(int(b) for b in bucket_boundaries)

    def collate(batch):
        lengths = np.asarray([len(np.asarray(s[ragged_fields[0]])) for s in batch],
                             np.int32)
        if int(lengths.max()) > boundaries[-1]:
            raise ValueError(
                f"padded_collate: sample length {int(lengths.max())} exceeds "
                f"the largest bucket boundary {boundaries[-1]}")
        target = next(bd for bd in boundaries if bd >= int(lengths.max()))
        padded = []
        for sample, n in zip(batch, lengths):
            fields = list(sample) if isinstance(sample, (list, tuple)) else [sample]
            for fi in ragged_fields:
                a = np.asarray(fields[fi])
                if a.shape[0] < target:
                    pad = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                    a = np.pad(a, pad, constant_values=pad_value)
                fields[fi] = a
            padded.append(tuple(fields) + (np.int32(n),))
        return default_collate_fn(padded)

    return collate


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (reference :318): the indices (shuffled by
    numpy `RandomState(epoch)`) padded to a multiple of `num_replicas`,
    every `num_replicas`-th from `rank`.  Without a process group this
    process is rank 0 of 1 unless `num_replicas` and `rank` are given;
    reading them from one comes with `distributed/` (ROADMAP Queue 1, item
    17)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = 1 if num_replicas is None else int(num_replicas)
        self.local_rank = 0 if rank is None else int(rank)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            np.random.RandomState(self.epoch).shuffle(indices)
        indices += indices[:self.total_size - n]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
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

    def state_dict(self):
        # the epoch seeds the shuffle, so it fixes this sampler's order
        return {"epoch": int(self.epoch)}

    def set_state_dict(self, state):
        self.set_epoch(int(state.get("epoch", 0)))


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------

# the reference's Tensor demotes 64-bit types (JAX runs with x64 off)
_DEMOTE = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def _np_collate(batch):
    """Stack a list of samples field by field: numpy arrays and numbers to
    numpy (python ints as int64, floats as float32), torch tensors to a
    torch tensor, tuples and lists to lists, dicts to dicts."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (bool, np.bool_)):
        return np.asarray(batch, np.bool_)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return [_np_collate(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _np_collate([d[k] for d in batch]) for k in sample}
    return batch


def _tensorize(obj):
    """Numpy arrays of a collated batch as CPU tensors (64-bit demoted)."""
    if isinstance(obj, np.ndarray):
        a = obj.astype(_DEMOTE[obj.dtype]) if obj.dtype in _DEMOTE else obj
        return torch.from_numpy(np.ascontiguousarray(a))
    if isinstance(obj, list):
        return [_tensorize(o) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_tensorize(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tensorize(v) for k, v in obj.items()}
    return obj


def default_collate_fn(batch):
    return _tensorize(_np_collate(batch))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


class WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None  # set inside DataLoader worker processes


def get_worker_info():
    """Inside a DataLoader worker process: its (id, num_workers, dataset),
    for per-worker sharding; None in the main process."""
    return _worker_info


class _Poison:
    """A producer's exception on its way to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Done:
    pass


_DONE = _Done()


class _Stopped(Exception):
    """A stage was closed while its thread waited on its queue."""


class _Enough(Exception):
    pass


class _CappedSink:
    """A file-like sink that stops a pickle after `cap` bytes: a probe of
    whether an object starts to pickle, without serialising all of it."""

    def __init__(self, cap):
        self.left = cap

    def write(self, b):
        self.left -= len(b)
        if self.left < 0:
            raise _Enough
        return len(b)


def _picklable(obj, cap=1 << 20):
    try:
        pickle.dump(obj, _CappedSink(cap), protocol=4)
    except _Enough:
        return True
    except Exception:
        return False
    return True


def _worker_loop(wid, nw, loader, collate, task_q, out_q, parent):
    """One forked worker: collate index batches until the None sentinel, or
    until its parent is gone."""
    global _worker_info
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        signal.signal(sig, signal.SIG_DFL)
    torch.set_num_threads(1)
    _worker_info = WorkerInfo(wid, nw, loader.dataset)
    try:
        if loader.worker_init_fn is not None:
            loader.worker_init_fn(wid)
    except Exception as e:
        out_q.put((-1, None, _pack_error(e)))
        return
    while True:
        try:
            item = task_q.get(timeout=1.0)
        except queue.Empty:
            if os.getppid() != parent:
                return
            continue
        if item is None:
            return
        bi, idxs = item
        try:
            # pickled here: a PicklingError in mp.Queue's feeder thread
            # would be lost and the parent would wait forever
            blob = pickle.dumps(collate([loader.dataset[i] for i in idxs]), protocol=4)
            out_q.put((bi, blob, None))
        except Exception as e:
            out_q.put((bi, None, _pack_error(e)))


def _pack_error(e):
    try:
        return pickle.dumps(e, protocol=4)
    except Exception:
        return pickle.dumps(RuntimeError(f"{type(e).__name__}: {e}"), protocol=4)


def _queue_get(q, stop):
    while True:
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            if stop.is_set():
                raise _Stopped from None


def _queue_put(q, item, stop):
    while True:
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            if stop.is_set():
                raise _Stopped from None


class _ThreadStage:
    """A producer thread feeding a bounded queue from `produce(emit)`, with
    the producer's exception carried to the consumer and a `close()` that
    stops the thread wherever it blocks."""

    def __init__(self, produce, maxsize, name, on_put=None):
        self.q = queue.Queue(maxsize=maxsize)
        self.stop = threading.Event()
        self.on_put = on_put

        def run():
            try:
                produce(self._emit)
                item = _DONE
            except _Stopped:
                return
            except BaseException as e:
                # without the pill a dying producer looks like an epoch end
                item = _Poison(e)
            try:
                _queue_put(self.q, item, self.stop)
            except _Stopped:
                pass

        self.thread = threading.Thread(target=run, name=name, daemon=True)
        self.thread.start()

    def _emit(self, item):
        _queue_put(self.q, item, self.stop)
        if self.on_put is not None:
            self.on_put(self.q.qsize())

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is _DONE:
                return
            if isinstance(item, _Poison):
                raise item.exc
            yield item

    def close(self):
        self.stop.set()
        self.thread.join(timeout=5)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


class DataLoader:
    """Batches of `dataset` (the reference's arguments; `feed_list`,
    `places`, `return_list`, `use_buffer_reader` and `persistent_workers`
    are accepted and have no effect, as there).

    num_workers: 0 collates in the consumer's thread; N > 0 forks N worker
        processes per epoch (a thread when the dataset cannot be pickled,
        or with use_shared_memory=False), each running ahead by at most
        `prefetch_factor` batches.
    prefetch_to_device: 0/False, True (2) or a depth N: batches reach the
        consumer already on `device`, copied from pinned memory on a side
        CUDA stream N - 1 batches ahead.
    device: where prefetched batches go; None is the card (raises without
        CUDA), "cpu" a CPU copy stage.
    generator: the torch.Generator of `shuffle` (torch's default CPU
        generator when None); its state at the epoch's start is the resume
        state.
    timeout: seconds to wait for a worker's batch (0: forever).
    """

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False,
                 prefetch_to_device=False, generator=None, device=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self._custom_collate = collate_fn is not None
        self.num_workers = int(num_workers)
        self.prefetch_factor = int(prefetch_factor)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.generator = generator
        self.prefetch_to_device = (2 if prefetch_to_device is True
                                   else int(prefetch_to_device or 0))
        self.device = (_core.resolve_device(device) if self.prefetch_to_device
                       else None)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last, generator=generator)
        # the exactly-once resume state: the epoch, the batches the consumer
        # has taken in it, the shuffle generator's state at its start, and
        # the deepest any prefetch queue got
        self._epoch = 0
        self._batches_consumed = 0
        self._resume_skip = 0
        self._epoch_rng_state = None
        self._prefetch_hwm = 0

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    # -- exactly-once resume --------------------------------------------------
    def _shuffle_generator(self):
        """The torch.Generator this loader's sampler draws from, or None
        when it draws from none (a sequence, bucket or distributed
        sampler)."""
        sampler = getattr(self.batch_sampler, "sampler", None)
        if not isinstance(sampler, (RandomSampler, WeightedRandomSampler)):
            return None
        gen = sampler.generator
        return gen if gen is not None else torch.default_generator

    def _generator_state(self):
        gen = self._shuffle_generator()
        return None if gen is None else gen.get_state().tolist()

    def state_dict(self):
        """The data position for exactly-once resume (JSON-serialisable):
        `batches_consumed` counts the batches the consumer has TAKEN this
        epoch, so a resume replays nothing and drops nothing."""
        rng = self._epoch_rng_state
        if rng is None:
            rng = self._generator_state()
        state = {"epoch": int(self._epoch),
                 "batches_consumed": int(self._batches_consumed),
                 "rng_state": rng, "prefetch_hwm": int(self._prefetch_hwm)}
        bs = self.batch_sampler
        if bs is not None and hasattr(bs, "state_dict"):
            state["sampler"] = bs.state_dict()
        return state

    def set_state_dict(self, state):
        self._epoch = int(state.get("epoch", 0))
        self._resume_skip = int(state.get("batches_consumed", 0))
        self._batches_consumed = self._resume_skip
        self._prefetch_hwm = int(state.get("prefetch_hwm", 0))
        rng, gen = state.get("rng_state"), self._shuffle_generator()
        if rng is not None and gen is not None:
            # the epoch's shuffle is drawn again from the same state, so the
            # skipped batches are exactly the consumed ones
            self._epoch_rng_state = [int(x) for x in rng]
            gen.set_state(torch.tensor(self._epoch_rng_state, dtype=torch.uint8))
        bs, samp = self.batch_sampler, state.get("sampler")
        if bs is not None and samp is not None:
            if hasattr(bs, "set_state_dict"):
                bs.set_state_dict(samp)
            elif hasattr(bs, "set_epoch"):
                bs.set_epoch(int(samp.get("epoch", 0)))
        return self

    load_state_dict = set_state_dict

    # -- iteration --------------------------------------------------------------
    def __iter__(self):
        skip, self._resume_skip = self._resume_skip, 0
        if skip == 0 or self._epoch_rng_state is None:
            # before the sampler draws: a mid-epoch checkpoint replays this
            self._epoch_rng_state = self._generator_state()
        self._batches_consumed = skip
        src = self._make_iter(skip)
        if self.prefetch_to_device:
            src = self._iter_prefetch_device(src, self.prefetch_to_device)
        try:
            while True:
                with _wd.arm("dataloader.next"):
                    _inj.inject_hang("dataloader.hang")
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                # counted before the consumer's step: a checkpoint taken
                # while batch k runs reports k + 1 consumed
                self._batches_consumed += 1
                yield batch
        finally:
            src.close()  # stops every worker and thread of this epoch
        self._epoch += 1
        self._batches_consumed = 0
        self._epoch_rng_state = None

    def _iter_batches(self, skip=0):
        """Collated batches in this thread; the first `skip` are skipped
        without being fetched (at the index level when there is one)."""
        if self._iterable_mode:
            emitted, batch = 0, []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    if emitted >= skip:
                        _inj.inject("dataloader.next")
                        yield self.collate_fn(batch)
                    emitted += 1
                    batch = []
            if batch and not self.drop_last and emitted >= skip:
                _inj.inject("dataloader.next")
                yield self.collate_fn(batch)
            return
        for bi, idx_batch in enumerate(self.batch_sampler):
            if bi < skip:
                continue
            _inj.inject("dataloader.next")
            yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def _make_iter(self, skip):
        if self.num_workers == 0:
            yield from self._iter_batches(skip)
        elif (self.use_shared_memory and not self._iterable_mode
              and _picklable(self.dataset)):
            yield from self._iter_multiprocess(skip)
        else:
            yield from self._iter_threaded(skip)

    def _note_depth(self, n):
        if n > self._prefetch_hwm:
            self._prefetch_hwm = n

    def _iter_threaded(self, skip=0):
        def produce(emit):
            src = self._iter_batches(skip)
            try:
                for b in src:
                    emit(b)
            finally:
                src.close()

        stage = _ThreadStage(produce, self.num_workers * self.prefetch_factor,
                             "dataloader-prefetch", self._note_depth)
        try:
            yield from stage
        finally:
            stage.close()

    def _iter_prefetch_device(self, src, depth):
        """Batches from `src` on self.device, `depth - 1` ahead.  On the
        card: pinned host copies, non_blocking copies on a side stream, and
        the consumer's stream waits on each batch's event (its tensors are
        recorded on that stream, so the allocator keeps them until the
        consumer's work is done).  Between producer and consumer counting:
        batches in this queue are not consumed yet."""
        device = self.device
        on_card = device.type == "cuda"
        side = torch.cuda.Stream(device) if on_card else None

        def move(obj):
            if isinstance(obj, torch.Tensor):
                if on_card:
                    return obj.pin_memory().to(device, non_blocking=True)
                return obj.to(device)
            if isinstance(obj, np.ndarray):
                return move(_tensorize(obj))
            if isinstance(obj, (list, tuple)):
                return type(obj)(move(o) for o in obj)
            if isinstance(obj, dict):
                return {k: move(v) for k, v in obj.items()}
            return obj

        def produce(emit):
            try:  # the thread owns src: closing it stops src's workers
                for b in src:
                    if not on_card:
                        emit((move(b), None))
                        continue
                    with torch.cuda.stream(side):
                        moved = move(b)
                        ev = torch.cuda.Event()
                        ev.record(side)
                    emit((moved, ev))
            finally:
                src.close()

        stage = _ThreadStage(produce, max(1, depth - 1), "h2d-prefetch",
                             self._note_depth)
        try:
            for moved, ev in stage:
                if ev is not None:
                    cur = torch.cuda.current_stream(device)
                    cur.wait_event(ev)
                    _record_stream(moved, cur)
                yield moved
        finally:
            stage.close()

    def _iter_multiprocess(self, skip=0):
        """Forked workers collate whole index batches (to numpy, unless a
        custom collate_fn returns something else); results come back
        pickled, are put back in batch order and tensorized here.  The
        dataloader.next fault point fires here, per batch handed over."""
        import multiprocessing as mp

        try:
            ctx = mp.get_context("fork")
        except ValueError:
            yield from self._iter_threaded(skip)
            return
        batches = list(self.batch_sampler)[skip:]
        nw = min(self.num_workers, max(len(batches), 1))
        ahead = nw * self.prefetch_factor
        task_q, out_q = ctx.Queue(), ctx.Queue()
        collate = self.collate_fn if self._custom_collate else _np_collate
        procs = [ctx.Process(target=_worker_loop, daemon=True,
                             args=(w, nw, self, collate, task_q, out_q, os.getpid()))
                 for w in range(nw)]
        try:
            for p in procs:
                p.start()
            sent = 0
            while sent < min(ahead, len(batches)):
                task_q.put((sent, list(batches[sent])))
                sent += 1
            pending = {}
            for want in range(len(batches)):
                while want not in pending:
                    bi, blob, err = _next_result(out_q, procs, self.timeout)
                    if err is not None:
                        exc = pickle.loads(err)
                        where = ("in worker_init_fn" if bi < 0
                                 else f"on batch {bi}")
                        exc.add_note(f"DataLoader worker failed {where}")
                        raise exc
                    pending[bi] = blob
                    self._note_depth(len(pending))
                batch = pickle.loads(pending.pop(want))
                if sent < len(batches):
                    task_q.put((sent, list(batches[sent])))
                    sent += 1
                _inj.inject("dataloader.next")
                yield batch if self._custom_collate else _tensorize(batch)
        finally:
            _stop_workers(procs, task_q, out_q)


def _next_result(out_q, procs, timeout):
    """The next (batch index, payload, error) from the workers; raises
    when `timeout` (> 0) passes without one, or when a worker died."""
    waited = 0.0
    while True:
        try:
            return out_q.get(timeout=1.0)
        except queue.Empty:
            waited += 1.0
        dead = [p for p in procs if p.exitcode not in (None, 0)]
        if dead:
            raise RuntimeError(f"DataLoader worker (pid {dead[0].pid}) exited "
                               f"with code {dead[0].exitcode}")
        if timeout and waited >= timeout:
            raise RuntimeError(f"DataLoader worker produced nothing for "
                               f"{timeout}s")


def _stop_workers(procs, task_q, out_q):
    """Stop and reap every worker: sentinels, a short join, then SIGTERM
    and SIGKILL for any still alive."""
    for p in procs:
        if p.is_alive():
            try:
                task_q.put(None)
            except (OSError, ValueError):
                pass
    for p in procs:
        if p.pid is not None:
            p.join(timeout=1.0)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)
        if p.is_alive():
            p.kill()
            p.join()
    for q in (task_q, out_q):
        q.cancel_join_thread()
        q.close()


def _record_stream(obj, stream):
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _record_stream(o, stream)
    elif isinstance(obj, dict):
        for o in obj.values():
            _record_stream(o, stream)
