"""Host input pipeline: batching, shuffling, micro-batch stacking and the
device prefetcher (counterpart of sasvqa_tpu/data/pipeline.py).

The sampler is deterministic and seeded.  A rank's share is always
passed explicitly (default: one process): its rows of every global batch
(``host_positions``, from ``parallel.mesh.host_batch_positions``), or the
older rank/world-size stride split; nothing is read from a distributed
runtime.  :class:`DevicePrefetcher` stages the next batch
into pinned host memory and copies it to the GPU on a side CUDA stream
while the current step computes (the reference's CUDA-stream
PrefetchLoader, src/datasets/dataloader.py:85-144).
:class:`MetaLoader` interleaves several tasks' batch streams by ratio.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.pixels import host_tensor
from sasvqa_torch.core.profiling import span

# batch keys that stay host-side lists (per-example ids, group sizes)
HOST_KEYS = ("question_ids", "n_examples_list")


def batch_indices(n: int, batch_size: int, shuffle: bool,
                  rng: Optional[np.random.Generator],
                  drop_last: bool = False,
                  order: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Chunk a sample ordering into batches.  ``order`` overrides the
    default arange/permutation (used by epoch_batches after per-rank
    sharding)."""
    if order is None:
        order = np.arange(n)
        if shuffle:
            if rng is None:
                raise ValueError("shuffle=True needs an rng")
            order = rng.permutation(n)
    batches = [order[i:i + batch_size] for i in range(0, len(order),
                                                      batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


def shard_for_host(indices: np.ndarray, rank: int = 0,
                   world_size: int = 1) -> np.ndarray:
    """Per-rank slice of a sample ordering: a deterministic stride split,
    padded to equal per-rank length by tiling the ordering from the front
    (torch DistributedSampler semantics), so that ranks consuming one
    batch per step stay in lockstep."""
    n = len(indices)
    total = -(-n // world_size) * world_size
    if total > n and n > 0:
        indices = np.resize(indices, total)
    return indices[rank::world_size]


def eval_batch_plan(n: int, global_bs: int):
    """Eval batch plan: yields (idx_padded, n_real_groups), sequential
    batches over ``n`` samples, each index list tiled (np.resize) to
    exactly ``global_bs`` rows.  Padding rows sit at the end, so
    consumers drop them by keeping the first n_real outputs."""
    if global_bs < 1:
        raise ValueError(f"global_bs must be >= 1, got {global_bs}")
    for start in range(0, n, global_bs):
        idx = np.arange(start, min(start + global_bs, n))
        yield np.resize(idx, global_bs), len(idx)


def collate_indices(dataset, collator, idx, rng) -> Dict[str, Any]:
    with span("input.collate"):
        items = [dataset.get_group(int(i)) for i in idx]
        return collator(items, rng=rng)


# -- collation in worker processes (``n_workers`` > 0; the reference's
# DataLoader workers): each task carries its batch indices and the seed of
# its collation generator, so a batch is the same whichever worker
# collates it, and results are taken in submission order.

_WORKER_STATE: Dict[str, Any] = {}


def _pool_init(dataset, collator) -> None:
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["collator"] = collator


def _pool_collate(task) -> Dict[str, Any]:
    idx, seed = task
    return collate_indices(_WORKER_STATE["dataset"],
                           _WORKER_STATE["collator"], idx,
                           np.random.default_rng(seed))


class CollatorPool:
    """``get_group`` + collation in ``n_workers`` worker processes.

    Workers are spawn-started (a fork of the multithreaded training
    process can inherit a held lock); each unpickles ``(dataset,
    collator)`` once, so both must pickle (FrameStoreReader reopens its
    file in the worker).  :meth:`imap` keeps at most ``2 * n_workers``
    tasks in flight and yields their batches in submission order.  A
    task's exception is raised in the consumer; a worker that dies fails
    the pool (``BrokenProcessPool``) and every later call, with no
    fallback to collation in the caller's thread.  :meth:`close` cancels
    the pending tasks, terminates the workers and joins them."""

    def __init__(self, dataset, collator, n_workers: int):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.n_workers = int(n_workers)
        self._executor = ProcessPoolExecutor(
            self.n_workers, mp_context=mp.get_context("spawn"),
            initializer=_pool_init, initargs=(dataset, collator))

    def imap(self, tasks) -> Iterator[Dict[str, Any]]:
        """tasks: iterable of (indices, seed) -> their batches in order."""
        from collections import deque
        pending: "deque" = deque()
        for task in tasks:
            pending.append(self._executor.submit(_pool_collate, task))
            if len(pending) >= 2 * self.n_workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    def close(self) -> None:
        # the executor terminates no running worker itself (Python 3.12)
        procs = list((self._executor._processes or {}).values())
        self._executor.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.join()
        self._executor.shutdown(wait=True)


def epoch_batches(dataset, collator, batch_size: int, shuffle: bool,
                  rng: Optional[np.random.Generator] = None,
                  drop_last: bool = False, rank: int = 0,
                  world_size: int = 1,
                  pool: Optional[CollatorPool] = None,
                  host_positions: Optional[np.ndarray] = None,
                  global_batch: Optional[int] = None
                  ) -> Iterator[Dict[str, Any]]:
    """One epoch of collated host batches of this rank's share, collated
    in ``pool``'s workers when one is given.

    General form (``host_positions`` + ``global_batch``): every rank
    walks the same permutation in global batches of ``global_batch``
    samples and collates the rows at ``host_positions`` of each;
    replicas (the same positions) collate identical rows with identical
    generators.  Stride form (``rank``/``world_size`` only): the rank's
    stride split of the permutation, in batches of ``batch_size``.

    Exactly two draws are taken from ``rng`` per epoch (a permutation
    seed and a collation seed), whatever the shard size or sampling
    policy, and each batch collates with its own generator seeded by
    (collation seed, rank, batch index), or in the general form by
    (collation seed, batch index, first position): the JAX package's
    stream, draw for draw, with or without a pool."""
    if shuffle:
        if rng is None:
            raise ValueError("shuffle=True needs an rng")
        perm_seed = int(rng.integers(0, 2 ** 63))
        order = np.random.default_rng(perm_seed).permutation(len(dataset))
    else:
        order = np.arange(len(dataset))
    collate_seed = (int(rng.integers(0, 2 ** 63))
                    if rng is not None else 0)
    if host_positions is not None:
        gb = int(global_batch)
        n_steps = len(order) // gb if drop_last else -(-len(order) // gb)
        if n_steps == 0:
            raise ValueError(
                f"{len(order)} samples yield zero drop_last global batches "
                f"of {gb}: training would spin forever; shrink the batch")
        if n_steps * gb > len(order):
            order = np.resize(order, n_steps * gb)
        pos = np.asarray(host_positions)
        batches = [order[t * gb + pos] for t in range(n_steps)]
        # seeded by the rank's row block: replicas collate identically,
        # disjoint blocks draw independently
        seeds = [(collate_seed, b, int(pos[0])) for b in range(n_steps)]
    else:
        if world_size > 1:
            order = shard_for_host(order, rank, world_size)
        if drop_last and len(order) < batch_size:
            raise ValueError(
                f"per-rank shard of {len(order)} samples yields zero "
                f"drop_last batches of size {batch_size}: training would "
                "spin forever; shrink the batch or the rank count")
        batches = batch_indices(len(order), batch_size, False, None,
                                drop_last=drop_last, order=order)
        seeds = [(collate_seed, rank, b) for b in range(len(batches))]
    if pool is not None:
        yield from pool.imap(zip(batches, seeds))
        return
    for idx, seed in zip(batches, seeds):
        yield collate_indices(dataset, collator, idx,
                              np.random.default_rng(seed))


def infinite_batches(dataset, collator, batch_size: int,
                     rng: np.random.Generator, drop_last: bool = True,
                     rank: int = 0, world_size: int = 1,
                     pool: Optional[CollatorPool] = None,
                     host_positions: Optional[np.ndarray] = None,
                     global_batch: Optional[int] = None
                     ) -> Iterator[Dict[str, Any]]:
    """Reshuffles each epoch and never ends (the reference's
    InfiniteIterator, dataloader.py:147-160); the share arguments are
    :func:`epoch_batches`'."""
    while True:
        yield from epoch_batches(dataset, collator, batch_size,
                                 shuffle=True, rng=rng, drop_last=drop_last,
                                 rank=rank, world_size=world_size, pool=pool,
                                 host_positions=host_positions,
                                 global_batch=global_batch)


def stack_microbatches(it: Iterator[Dict[str, Any]], k: int,
                       host_keys=HOST_KEYS) -> Iterator[Dict[str, Any]]:
    """Group K consecutive host batches into one stacked batch with a
    leading micro axis, for ``train.steps.make_scan_train_step``: array
    leaves become (K, B, ...), host keys become lists of per-micro
    values, and a leaf that is None must be None in every micro.  All K
    micros must share leaf shapes (fixed collator buckets, drop_last
    batching); an incomplete trailing group is dropped."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    it = iter(it)
    while True:
        group = []
        for _ in range(k):
            try:
                group.append(next(it))
            except StopIteration:
                return
        out: Dict[str, Any] = {}
        for key in group[0]:
            vals = [g[key] for g in group]
            if key in host_keys:
                out[key] = vals
            elif vals[0] is None:
                if any(v is not None for v in vals):
                    raise ValueError(f"leaf {key!r} is None in only some "
                                     f"micro-batches")
                out[key] = None
            else:
                shapes = {np.asarray(v).shape for v in vals}
                if len(shapes) != 1:
                    raise ValueError(
                        f"micro-batch leaf {key!r} shapes differ across the "
                        f"accumulation window: {shapes}")
                out[key] = np.stack(vals)
        yield out


class MetaLoader:
    """Ratio-weighted multi-task batch interleaver (reference:
    src/datasets/dataloader.py:14-55, used by its pretrain path).  Yields
    (task_name, batch) drawn from per-task infinite iterators with
    probability proportional to the given ratios, deterministically from
    a seeded ``np.random.Generator`` (the JAX package's draws)."""

    def __init__(self, loaders, rng: np.random.Generator):
        """loaders: {name: iterator} or {name: (iterator, ratio)}."""
        if not loaders:
            raise ValueError("MetaLoader needs at least one loader")
        self.names: List[str] = []
        self.iters: List[Any] = []
        ratios: List[float] = []
        for name, loader in loaders.items():
            it, r = loader if isinstance(loader, tuple) else (loader, 1)
            self.names.append(name)
            self.iters.append(it)
            ratios.append(float(r))
        p = np.asarray(ratios, np.float64)
        self._p = p / p.sum()
        self._rng = rng

    def __iter__(self):
        return self

    def __next__(self):
        task = int(self._rng.choice(len(self.iters), p=self._p))
        return self.names[task], next(self.iters[task])


_SENTINEL = object()


class DevicePrefetcher:
    """A background thread that collates the next host batch and stages
    it on ``device`` while the current step computes.

    On a GPU each array leaf is copied into pinned host memory and sent
    with a non-blocking copy on a side CUDA stream; an event recorded
    after the copies is what the consumer's stream waits on, so the step
    never reads a half-copied batch and the host never blocks on the
    copy.  On the CPU the leaves become tensors in place.  Leaves keep
    their staging dtype (bf16, f32 or u8 pixels, int32 text).  Yields
    ``(arrays, host)``: the leaves as tensors (None stays None) and the
    ``HOST_KEYS`` lists."""

    HOST_KEYS = HOST_KEYS

    def __init__(self, it: Iterator[Dict[str, Any]], depth: int = 2,
                 device: DeviceLike = "cuda"):
        self._dev = resolve_device(device)
        self._cuda = self._dev.type == "cuda"
        self._stream = torch.cuda.Stream(self._dev) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src = it
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, Any]):
        host = {k: batch.pop(k) for k in list(batch) if k in self.HOST_KEYS}
        arrays: Dict[str, Optional[torch.Tensor]] = {}
        event = None
        if self._cuda:
            with torch.cuda.stream(self._stream):
                for k, v in batch.items():
                    arrays[k] = None if v is None else host_tensor(
                        v).pin_memory().to(self._dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            for k, v in batch.items():
                arrays[k] = None if v is None else host_tensor(v)
        return arrays, host, event

    def _put(self, item) -> bool:
        """Stop-aware blocking put; False once close() was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for batch in self._src:
                if not self._put(self._stage(batch)):
                    return
        except BaseException as e:  # surfaced in the consumer's thread
            self._err = e
        finally:
            # the sentinel must land, or a consumer blocked in get() waits
            # forever and never sees the error
            self._put(_SENTINEL)

    def close(self):
        """Stop the producer and release the staged batches.

        Join first, then drain: draining first would let a producer
        blocked in put() re-insert a staged batch after the drain, leaving
        it pinned for the rest of the run."""
        self._stop.set()
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            LOGGER.warning("DevicePrefetcher producer thread did not exit "
                           "within 5s; staged batches may stay pinned in "
                           "device memory")
            self._drain()
            self._thread.join(timeout=5)
        self._drain()

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        arrays, host, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._dev)
            stream.wait_event(event)
            for t in arrays.values():
                if t is not None:
                    t.record_stream(stream)
        return arrays, host
