"""Deterministic, prefetching batch stream (port of
``vqvae_tpu/audio/loader.py``).

Batch ``i`` is a pure function of ``(seed, i)``: its rows are drawn
from ``np.random.default_rng(SeedSequence([seed, i]))``, exactly the
JAX package's stream, so a run started at ``start_batch=N`` continues
where a straight run would be.  Worker threads build batches ahead
(decoding and trimming WAV files is host work; numpy and scipy release
the interpreter lock in their hot parts) and may finish out of order; a
single emitter thread releases them strictly in index order into a
bounded queue, so the stream does not depend on the threads' timing.
"""

from __future__ import annotations

import heapq
import queue
import threading
from typing import Iterator, Tuple

import numpy as np


class BatchLoader:
    """Iterator of (wav ``[B, length+1]`` float32, speaker ``[B]``
    int32).  ``close()`` stops its threads."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 start_batch: int = 0, num_threads: int = 2,
                 prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._next_index = start_batch       # next index to hand out
        self._emit_index = start_batch       # next index to emit
        self._index_lock = threading.Lock()
        self._heap: list = []                # (index, batch) reorder buffer
        self._heap_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, num_threads))]
        self._threads.append(threading.Thread(target=self._emitter,
                                              daemon=True))
        for t in self._threads:
            t.start()

    def make_batch(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                            index]))
        wavs, spks = zip(*(self.dataset.sample(rng)
                           for _ in range(self.batch_size)))
        return np.stack(wavs), np.asarray(spks, dtype=np.int32)

    def _worker(self) -> None:
        while not self._stop.is_set():
            with self._index_lock:
                index = self._next_index
                self._next_index += 1
            # back-pressure: decode at most a few batches ahead
            while (not self._stop.is_set()
                   and index - self._emit_index > 4 * len(self._threads)):
                self._stop.wait(0.01)
            if self._stop.is_set():
                return
            # a failed batch keeps its slot (as the exception) so the
            # in-order emitter does not stall; __next__ raises it
            try:
                batch = self.make_batch(index)
            except Exception as exc:  # noqa: BLE001 - re-raised in __next__
                batch = exc
            with self._heap_lock:
                heapq.heappush(self._heap, (index, batch))

    def _emitter(self) -> None:
        """Releases batches strictly in index order."""
        while not self._stop.is_set():
            batch = None
            with self._heap_lock:
                if self._heap and self._heap[0][0] == self._emit_index:
                    batch = heapq.heappop(self._heap)[1]
            if batch is None:
                self._stop.wait(0.002)
                continue
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    self._emit_index += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        batch = self._q.get()
        if isinstance(batch, Exception):
            self.close()
            raise batch
        return batch

    def close(self) -> None:
        self._stop.set()
        while True:                      # unblock an emitter waiting to put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        current = threading.current_thread()
        for t in self._threads:
            if t is not current:
                t.join(timeout=5.0)
