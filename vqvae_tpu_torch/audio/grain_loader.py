"""Worker-process batch loader (port of ``vqvae_tpu/audio/grain_loader.py``;
``--loader grain``), an alternative host pipeline to
``audio/loader.py::BatchLoader``.

The JAX package builds it on the ``grain`` package, which the card's
machine lacks, so the port builds it on ``torch.utils.data.DataLoader``
with the same design: a map-style source whose record ``i`` is the whole
batch ``start_batch + i``, built by ``audio/loader.py::make_batch``, the
function ``BatchLoader`` builds its batches with (the JAX package's
``SeedSequence([seed, index])`` walk of ``dataset.sample``).  The stream
is therefore bit-identical to the threaded loader's and to the JAX
package's, so the loaders are interchangeable mid-training and
``start_batch=N`` resumes either.

``num_workers=0`` (the default, as the JAX trainer passes none) builds
the batches on one background thread of the calling process, up to
``prefetch`` ahead of the consumer, as the JAX package's
``ReadOptions(num_threads=1, prefetch_buffer_size=prefetch)`` does.
With workers, each worker process builds whole batches, and the
DataLoader hands them back in index order, whichever worker finishes
first.
"""

from __future__ import annotations

import itertools
import multiprocessing
import queue
import threading
from typing import Iterator, Tuple

import numpy as np
from torch.utils.data import DataLoader, Dataset, Sampler

from vqvae_tpu_torch.audio.loader import BatchLoader, make_batch


class _BatchSource(Dataset):
    """Record ``i`` = batch ``start_batch + i``: (wav ``[B, length+1]``
    float32, speaker ``[B]`` int32)."""

    def __init__(self, dataset, batch_size: int, seed: int,
                 start_batch: int):
        self._dataset = dataset
        self._batch_size = batch_size
        self._seed = seed
        self._start = start_batch

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return make_batch(self._dataset, self._batch_size, self._seed,
                          self._start + i)


class _Endless(Sampler):
    """Indices 0, 1, 2, ... drawn one at a time: the DataLoader asks for
    only as many as its workers' prefetch allows (training is
    open-ended, and an eager feeder would run through them without
    bound)."""

    def __iter__(self) -> Iterator[int]:
        return itertools.count()


def _as_is(batch):
    """Keep the batch as numpy (DataLoader's default converts to torch)."""
    return batch


class _ReadAhead:
    """Records 0, 1, 2, ... of ``source`` built on one thread, at most
    ``prefetch`` ahead of ``next()``.  An exception in the reader is
    raised by the ``next()`` that would have returned its record;
    ``close()`` stops and joins the thread."""

    def __init__(self, source: _BatchSource, prefetch: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._read, args=(source,),
                                        name="grain-read-ahead", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _read(self, source: _BatchSource) -> None:
        for i in itertools.count():
            try:
                item = (source[i], None)
            except BaseException as exc:  # handed to the consumer
                self._put((None, exc))
                return
            if not self._put(item):
                return

    def __next__(self):
        if self._exc is None:
            batch, self._exc = self._q.get()
            if self._exc is None:
                return batch
        raise self._exc   # and again at every later call

    def close(self) -> None:
        self._stop.set()
        self._thread.join()


class GrainBatchLoader:
    """Drop-in replacement for ``BatchLoader`` with worker processes: the
    same constructor contract (``num_threads`` is accepted and ignored,
    so call sites switch loaders without changing arguments) and the
    same deterministic stream.  ``prefetch`` bounds the batches in
    flight: on the read-ahead thread at ``num_workers=0``, across all
    workers otherwise (at least one a worker).  ``close()`` stops and
    joins the thread or the workers."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 0, prefetch: int = 4,
                 start_batch: int = 0, num_threads: int | None = None):
        source = _BatchSource(dataset, batch_size, seed, start_batch)
        if num_workers == 0:
            self._dl, self._it = None, _ReadAhead(source, prefetch)
            return
        # spawn, not fork: the parent may hold a CUDA context and the
        # threaded loader's or the evaluator's threads, which a forked
        # child would inherit in an unknown state.  A spawned worker
        # starts from a fresh import, touches no CUDA, and gets the
        # source (the dataset included) by pickle.
        self._dl = DataLoader(
            source, batch_size=None, sampler=_Endless(),
            num_workers=num_workers, collate_fn=_as_is,
            multiprocessing_context=multiprocessing.get_context("spawn"),
            prefetch_factor=max(1, -(-prefetch // num_workers)))
        self._it = iter(self._dl)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._it is None:
            raise StopIteration
        return next(self._it)

    def close(self) -> None:
        # reap the thread or the workers now, not whenever the iterator
        # is collected (BatchLoader.close parity); the multi-process
        # iterator's own shutdown joins its workers
        it, self._it, self._dl = self._it, None, None
        if isinstance(it, _ReadAhead):
            it.close()
            return
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def make_loader(kind: str, dataset, batch_size: int, seed: int = 0,
                start_batch: int = 0, **kw):
    """Loader factory: ``kind`` in {"threads", "grain"}."""
    if kind == "grain":
        return GrainBatchLoader(dataset, batch_size, seed=seed,
                                start_batch=start_batch, **kw)
    if kind == "threads":
        return BatchLoader(dataset, batch_size, seed=seed,
                           start_batch=start_batch, **kw)
    raise ValueError(f"unknown loader kind: {kind!r}")
