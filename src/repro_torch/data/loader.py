"""Step-indexed loader and a bounded background prefetch.

``ShardedLoader`` yields ``make_batch(step)`` step by step and carries its
position in ``state_dict`` (the reference's loader also slices each batch to
this host's rows of a mesh; one card has none). ``Prefetcher`` overlaps
host-side batch generation with device compute through a bounded background
thread: a slow producer never stalls more than ``depth`` steps, and a
producer's exception is raised in the consumer.

The thread makes host batches only. Tensors made in a thread are ordered on
that thread's CUDA stream, so the consumer moves each batch to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator


class ShardedLoader:
    """``make_batch(step)`` → a batch (a tree of host tensors), for
    ``step`` = ``start_step``, ``start_step`` + 1, ..."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int = 0):
        self.make_batch = make_batch
        self.step = start_step

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        batch = self.make_batch(self.step)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {'step': self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state['step'])


class Prefetcher:
    """Bounded background prefetch over any iterator. ``close()`` stops
    the thread (the iterator may be endless)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
            except Exception as e:          # raised in the consumer
                self._err = e
            put(self._SENTINEL)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._SENTINEL:
            self.q.put(self._SENTINEL)      # every later call ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer and wait for its thread."""
        self._stop.set()
        self.thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
