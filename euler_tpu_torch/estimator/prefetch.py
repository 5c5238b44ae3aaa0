"""Host-side batch prefetching: overlap graph sampling with device compute
(counterpart: euler_tpu/estimator/prefetch.py).

Producer threads keep a bounded queue of ready batches ahead of the
training step. With device_put=True each worker also stages its batch
on the device: the arrays are copied into page-locked host memory and
sent to the card without blocking, on a CUDA stream of the worker's own,
and an event recorded after the copies travels with the batch. The
consumer's stream waits for that event before the batch is handed over,
and every staged tensor is marked as used on the consumer's stream
(`record_stream`), so no batch is read before its copy has landed and
no staged buffer is reused while the step still reads it. The leaves a
lean batch leaves out stay None.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import torch

from euler_tpu_torch.dataflow.base import MiniBatch, to_device
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.estimator.graph_step import tensor_leaves


class Prefetcher:
    """Wraps batch_fn() in N producer threads + a bounded queue.

    With device_put=True, workers also stage each batch's MiniBatches on
    `device` (the CUDA card unless device="cpu"), so host→device copies
    overlap the previous step instead of serialising with it.
    """

    def __init__(
        self,
        batch_fn: Callable[[], tuple],
        depth: int = 4,
        workers: int = 2,
        device_put: bool = False,
        device=None,
    ):
        self.batch_fn = batch_fn
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._produce, daemon=True)
            for _ in range(workers)
        ]
        self._error = None
        for t in self._threads:
            t.start()

    def _stage(self, item, stream):
        """(item with its MiniBatches on the device, the event after their
        copies or None)."""
        if stream is None:
            return tuple(to_device(b, self.device) if isinstance(b, MiniBatch) else b
                         for b in item), None
        with torch.cuda.stream(stream):
            staged = tuple(to_device(b, self.device, pinned=True) if isinstance(b, MiniBatch)
                           else b for b in item)
            done = torch.cuda.Event()
            done.record(stream)
        return staged, done

    def _produce(self):
        stream = None
        while not self._stop.is_set():
            try:
                item = self.batch_fn()
                if self.device_put:
                    if stream is None and self.device.type == "cuda":
                        stream = torch.cuda.Stream(self.device)
                    item = self._stage(item, stream)
            except Exception as e:  # surfaced to the consumer
                self._error = e
                self._stop.set()
                break
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __call__(self) -> tuple:
        while True:
            if self._error is not None:
                raise self._error
            try:
                item = self.q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set() and self._error is None:
                    raise RuntimeError("prefetcher stopped")
                continue
            if not self.device_put:
                return item
            item, done = item
            if done is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(done)
                for b in item:
                    for t in tensor_leaves(b) if isinstance(b, MiniBatch) else ():
                        t.record_stream(current)
            return item

    def close(self, timeout_s: float = 5.0):
        """Stop the producers and join their threads (bounded), draining
        the queue until they are joined, so no worker blocked in `q.put`
        publishes a stale batch after close() returns; workers stuck in a
        slow batch_fn are abandoned after `timeout_s` (daemon threads)."""
        self._stop.set()
        deadline = time.monotonic() + timeout_s
        alive = [t for t in self._threads if t.is_alive()]
        while alive and time.monotonic() < deadline:
            self._drain()
            for t in alive:
                t.join(timeout=0.05)
            alive = [t for t in alive if t.is_alive()]
        self._drain()

    def _drain(self):
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                return
