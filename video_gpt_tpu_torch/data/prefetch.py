"""Background batch prefetcher.

Port of ``video_gpt_tpu/data/prefetch.py``: worker threads decode and
collate the next batches while the device runs the current step (cv2 decode
releases the GIL), and the consumer receives them strictly in index order.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], object], depth: int = 2,
                 workers: int = 1, start: int = 0):
        """``make_batch(step_index)`` must be thread-safe. ``start`` sets the
        first index (a resumed run continues the data order instead of
        replaying it from 0)."""
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start
        self._consume = start       # next index the consumer must see
        self._pending: dict = {}    # out-of-order arrivals (workers > 1)
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(workers)]
        for t in self._threads:
            t.start()

    def _run(self):
        while not self._stop.is_set():
            with self._lock:
                idx = self._next
                self._next += 1
            try:
                batch = self._make(idx)
            except Exception as e:  # raised again on the consumer's side
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((idx, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def get(self):
        """The next batch in index order: with several workers racing, later
        indices may arrive first and wait in ``_pending`` (at most about
        ``workers`` entries) for their turn."""
        while self._consume not in self._pending:
            idx, batch = self._q.get()
            self._pending[idx] = batch
        batch = self._pending.pop(self._consume)
        self._consume += 1
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        self._stop.set()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        # join the workers: a daemon thread still inside native code (cv2)
        # when the interpreter finalises aborts the process
        for t in self._threads:
            t.join(timeout=10.0)
