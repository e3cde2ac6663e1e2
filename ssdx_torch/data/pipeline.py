"""Host input pipeline: threaded JPEG decode -> fixed-shape batches ->
augmentation on the device, with a one-deep prefetch.

The port's counterpart of ``ssdx/data/pipeline.py``, with the same
observable behaviour:

  * host threads (cv2 releases the GIL) decode JPEGs to a fixed source size
    and assemble *fixed-shape* uint8 batches with padded GT and validity
    masks;
  * the uint8 batch goes to the device (through pinned memory with
    ``non_blocking=True`` when that is a GPU) and the augmentation or the
    eval preprocessing (``ssdx_torch/data/augment.py``) runs there, giving
    the final :class:`~ssdx_torch.train.step.Batch`;
  * a one-deep background prefetch overlaps decode and the copy with the
    train step;
  * the epoch order is ``np.random.default_rng(seed + epoch).permutation``
    of the (bootstrap-repeated) indices, the same files in the same order as
    the JAX loader; the augmentation's random numbers come from a
    ``torch.Generator`` seeded with ``seed`` and differ from ``jax.random``'s.

Bootstrap oversampling: file repetition by object count: 0 objects x1,
1-2 x2, 3-6 x3, 7-9 x4, >=10 x5.

Under a ``mesh`` (:mod:`ssdx_torch.mesh`) ``batch_size`` is the global batch:
every rank derives the same epoch permutation and decodes only its
contiguous slice of each global batch, and draws the whole global batch's
augmentation numbers from the same seeded generator before it takes its
rows, so the ranks' batches together are the single-process batch.
"""
from __future__ import annotations

import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..train.step import Batch
from .augment import AugmentConfig, AugmentDraws, augment_core, preprocess_batch, sample_draws

__all__ = ["bootstrap_repeats", "bootstrap_indices", "DetectionLoader", "LoadedBatch"]


def bootstrap_repeats(n_boxes: int) -> int:
    """Oversampling factor by object count."""
    if n_boxes == 0:
        return 1
    if n_boxes <= 2:
        return 2
    if n_boxes <= 6:
        return 3
    if n_boxes <= 9:
        return 4
    return 5


def bootstrap_indices(dataset) -> np.ndarray:
    """Index list with each image repeated by its bootstrap factor."""
    out = []
    for i in range(len(dataset)):
        _, labels = dataset.annotations(i)
        out.extend([i] * bootstrap_repeats(len(labels)))
    return np.asarray(out, np.int64)


class LoadedBatch(NamedTuple):
    batch: Batch
    count: int  # number of real (non-padded) images in this batch


class DetectionLoader:
    """Iterable over :class:`LoadedBatch` for one dataset.

    train=True: shuffled (a fresh permutation per epoch), optional bootstrap
    oversampling, partial trailing batch dropped, augmentation on the device.
    train=False: deterministic order, trailing batch padded by wrap-around
    (``count`` marks the real images), resize and normalize only.

    ``dataset`` is a :class:`~ssdx_torch.data.dataset.DetectionDataset` or
    any object with its ``__len__``, ``load_image``, ``annotations``,
    ``max_boxes_per_image`` and ``native_size``.  ``device=None`` is the
    mesh's device, or without a mesh the GPU (see
    :func:`ssdx_torch.resolve_device`).

    ``mesh``: each rank loads ``batch_size // mesh.size`` images of every
    global batch; ``LoadedBatch.count`` stays the global count of real
    images.  ``process_index`` and ``process_count`` override the mesh's rank
    and size (tests); a count above 1 needs a mesh.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        train: bool,
        source_size: int | None = None,
        max_boxes: int | None = None,
        num_workers: int = 8,
        seed: int = 724,
        bootstrap: bool = False,
        augment_cfg: AugmentConfig | None = None,
        prefetch: bool = True,
        cache_images: bool = False,
        device=None,
        mesh=None,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if process_count is None:
            process_count = 1 if mesh is None else mesh.size
        if process_index is None:
            process_index = 0 if mesh is None else mesh.rank
        self.process_count, self.process_index = process_count, process_index
        if batch_size % process_count:
            raise ValueError(f"global batch_size={batch_size} must divide evenly over "
                             f"{process_count} processes")
        self.local_batch_size = batch_size // process_count
        if process_count > 1 and mesh is None:
            raise ValueError("multi-process loading requires a mesh")
        self.stats = {"decoded": 0}
        if source_size is None:
            # The dataset's uniform square native resolution, so that eval is
            # ONE antialiased resample native -> 300; other datasets go
            # through a 512 host intermediate.
            ns = dataset.native_size()
            if ns is not None and ns[0] == ns[1] and ns[0] <= 1024:
                source_size = ns[0]
            else:
                source_size = 512
        self.source_size = source_size
        # Size the fixed GT padding from the dataset so that no ground truth
        # is silently dropped; an explicit smaller max_boxes warns up front.
        ds_max = dataset.max_boxes_per_image()
        if max_boxes is None:
            max_boxes = max(1, ds_max)
        elif ds_max > max_boxes:
            warnings.warn(
                f"max_boxes={max_boxes} is smaller than the dataset's largest "
                f"image ({ds_max} boxes): ground truth WILL be truncated, "
                "corrupting training targets and eval mAP. Pass max_boxes=None "
                "to auto-size.",
                stacklevel=2,
            )
        self.max_boxes = max_boxes
        self.num_workers = num_workers
        self.seed = seed
        self.bootstrap = bootstrap
        self.augment_cfg = augment_cfg if augment_cfg is not None else AugmentConfig()
        self.prefetch = prefetch
        self._epoch = 0
        self._base_indices = (
            bootstrap_indices(dataset) if (train and bootstrap) else np.arange(len(dataset))
        )
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # Optional in-RAM cache of decoded images (after the source-size
        # resize): trades source_size^2 * 3 bytes per image for the decode on
        # hosts with few cores.  stats['decoded'] then counts misses only.
        self._cache: dict[int, tuple] | None = {} if cache_images else None

    def __len__(self) -> int:
        n = len(self._base_indices)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    # ---- host side ----

    def _load_one(self, idx: int):
        idx = int(idx)
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return hit
        img = self.dataset.load_image(idx)
        self.stats["decoded"] += 1
        boxes, labels = self.dataset.annotations(idx)
        h, w = img.shape[:2]
        s = self.source_size
        if (h, w) != (s, s):
            import cv2

            img = cv2.resize(img, (s, s), interpolation=cv2.INTER_AREA)
            boxes = boxes * np.array([s / w, s / h, s / w, s / h], np.float32)
        if self._cache is not None:
            # benign race: two threads may decode the same index once each;
            # dict assignment is atomic so the cache stays consistent
            self._cache[idx] = (img, boxes, labels)
        return img, boxes, labels

    def _assemble(self, idxs: np.ndarray) -> tuple[np.ndarray, ...]:
        B, s, G = len(idxs), self.source_size, self.max_boxes
        images = np.zeros((B, s, s, 3), np.uint8)
        boxes = np.zeros((B, G, 4), np.float32)
        labels = np.zeros((B, G), np.int32)
        valid = np.zeros((B, G), bool)
        results = list(self._pool.map(self._load_one, idxs))
        for j, (img, bx, lb) in enumerate(results):
            images[j] = img
            n = min(len(lb), G)
            if len(lb) > G:
                warnings.warn(
                    f"truncating {len(lb) - G} of {len(lb)} GT boxes to "
                    f"max_boxes={G} (image index {int(idxs[j])})",
                    stacklevel=2,
                )
            boxes[j, :n] = bx[:n]
            labels[j, :n] = lb[:n]
            valid[j, :n] = True
        return images, boxes, labels, valid

    def _epoch_indices(self) -> np.ndarray:
        idx = self._base_indices
        if self.train:
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = rng.permutation(idx)
        return idx

    # ---- device side ----

    def _put(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_device(self, arrays) -> Batch:
        images_u8, boxes, labels, valid = map(self._put, arrays)
        if self.train:
            # the global batch's draws, of which this rank takes its rows
            draws = sample_draws(self._gen, self.batch_size, self.augment_cfg, self.device)
            lo = self.process_index * self.local_batch_size
            draws = AugmentDraws(*(d[lo:lo + self.local_batch_size] for d in draws))
            img, b01, lb, vd = augment_core(images_u8, boxes, labels, valid, draws,
                                            self.augment_cfg)
        else:
            img, b01 = preprocess_batch(images_u8, boxes)
            lb, vd = labels, valid
        return Batch(images=img, gt_boxes=b01, gt_labels=lb, gt_valid=vd)

    def _batches(self) -> Iterator[LoadedBatch]:
        idx = self._epoch_indices()
        B = self.batch_size
        n = len(idx)
        stop = (n // B) * B if self.train else n
        for start in range(0, stop, B):
            chunk = idx[start : start + B]
            count = len(chunk)
            if count < B:  # eval tail: wrap-around padding
                chunk = np.concatenate([chunk, idx[: B - count]])
            if self.process_count > 1:  # this rank's slice of the global batch
                lo = self.process_index * self.local_batch_size
                chunk = chunk[lo : lo + self.local_batch_size]
            yield LoadedBatch(self._to_device(self._assemble(chunk)), count)
        self._epoch += 1

    def __iter__(self) -> Iterator[LoadedBatch]:
        if not self.prefetch:
            yield from self._batches()
            return
        # one-deep background prefetch: overlap decode and the copy with the
        # consumer
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._batches():
                    if not _put(item):
                        return  # consumer went away
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True, name="ssdx-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # unblock and reap the producer even if the consumer broke early
            stop.set()
            while not q.empty():
                q.get_nowait()
            t.join(timeout=5.0)
        if err:
            raise err[0]
