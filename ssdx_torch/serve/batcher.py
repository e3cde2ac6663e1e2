"""Cross-request micro-batching for the serving app.

The port's own copy of ``ssdx/serve/batcher.py``.  ``MicroBatcher`` sits
between the HTTP handlers and the ``Detector``: requests arriving within a
short window (``max_wait_ms``, default 4 ms) are stacked into ONE batched
forward + postprocess dispatch, padded up to a power-of-two bucket
(1, 2, 4, ..., max_batch) so the device sees a handful of batch shapes.
Requests with different decode thresholds are grouped separately.

It duck-types the two attributes the render path uses (``predict_pil``,
``idx_to_class``; ssdx_torch/viz.py), so it drops in wherever a
``Detector`` is accepted.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

__all__ = ["MicroBatcher"]


@dataclass
class _Item:
    arr: np.ndarray  # [1, 300, 300, 3]
    kwargs: dict
    future: Future = field(default_factory=Future)

    @property
    def key(self) -> tuple:
        return tuple(sorted(self.kwargs.items()))


class MicroBatcher:
    """Batch concurrent ``predict_pil`` calls into single device dispatches."""

    def __init__(
        self,
        detector,
        max_batch: int = 8,
        max_wait_ms: float = 4.0,
        request_timeout_s: float = 600.0,
        warmup: bool = False,
        warmup_kwargs: dict | None = None,
    ):
        self.detector = detector
        self.idx_to_class = detector.idx_to_class
        self.warmup_kwargs = dict(warmup_kwargs or {})
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.request_timeout_s = request_timeout_s
        self._buckets = []
        b = 1
        while b < self.max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_batch)
        self.stats = {"batches": 0, "images": 0, "max_batch_seen": 0}
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.warm = threading.Event()  # set once the warm-up has ended
        if warmup:
            # Run every batch bucket once in the background (the first call
            # builds the CUDA kernels); requests arriving meanwhile queue.
            threading.Thread(target=self._warmup_buckets, daemon=True).start()
        else:
            self.warm.set()

    def _warmup_buckets(self) -> None:
        try:
            for b in self._buckets:
                self.detector.predict(
                    np.zeros((b, 300, 300, 3), np.float32),
                    **self.warmup_kwargs)
        except Exception:
            pass  # warmup is best-effort
        finally:
            self.warm.set()

    # ---- public surface (Detector-compatible) ----

    def predict_pil(self, pil_img, **kwargs) -> dict:
        arr = self.detector.preprocess_pil(pil_img)
        item = _Item(np.asarray(arr), kwargs)
        self._q.put(item)
        return item.future.result(timeout=self.request_timeout_s)

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5.0)

    # ---- worker ----

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _collect(self) -> list[_Item] | None:
        """Block for the first request, then sweep the window."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-deliver shutdown after this batch
                break
            batch.append(nxt)
        return batch

    def _worker(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            groups: dict[tuple, list[_Item]] = {}
            for it in batch:
                groups.setdefault(it.key, []).append(it)
            for items in groups.values():
                self._run_group(items)

    def _run_group(self, items: list[_Item]) -> None:
        try:
            n = len(items)
            bucket = self._bucket(n)
            arrs = np.concatenate([it.arr for it in items], axis=0)
            if bucket > n:  # pad to the bucket's batch shape
                pad = np.zeros((bucket - n,) + arrs.shape[1:], arrs.dtype)
                arrs = np.concatenate([arrs, pad], axis=0)
            preds = self.detector.predict(arrs, **items[0].kwargs)
            self.stats["batches"] += 1
            self.stats["images"] += n
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n)
            for it, pred in zip(items, preds):
                it.future.set_result(pred)
        except Exception as e:  # propagate to every waiter, keep serving
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)
