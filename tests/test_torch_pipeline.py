"""The port's loader (ssdx_torch.data.pipeline) against the JAX package's, on
a toy directory of JPEGs, both on the CPU.

Bootstrap factors and indices must be equal.  With an augmentation
configuration that draws nothing effective (sentinel-only crop options, no
flip, no photometric ops) a training batch is a deterministic function of
its files, so whole epochs can be compared: the same files in the same
order over two epochs (the permutation of ``seed + epoch``, bootstrap
repeats, the dropped partial batch), and for eval the wrap-padded tail and
its ``count``.  Images agree within 2e-5 on normalized values (XLA's CPU
einsum is 3.4e-6 off the float64 resample, times 1/std), boxes within 1e-5.
"""
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from ssdx.data.augment import AugmentConfig as JaxAugmentConfig
from ssdx.data.dataset import DetectionDataset as JaxDataset
from ssdx.data.pipeline import DetectionLoader as JaxLoader
from ssdx.data.pipeline import bootstrap_indices as jax_bootstrap_indices
from ssdx.data.pipeline import bootstrap_repeats as jax_bootstrap_repeats
from ssdx_torch.data.augment import AugmentConfig
from ssdx_torch.data.dataset import DetectionDataset
from ssdx_torch.data.pipeline import (DetectionLoader, bootstrap_indices, bootstrap_repeats)

IDENTITY = dict(small_sampler_options=(2.0,), large_sampler_options=(2.0,), hflip_prob=0.0,
                photometric_prob=0.0)


@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    """22 images of 40x40 with 0 to 11 boxes each (every bootstrap factor),
    one of them annotated 'empty'."""
    import cv2

    d = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(22):
        name = f"t{i:02d}.jpg"
        cv2.imwrite(str(d / name), rng.integers(0, 255, (40, 40, 3), np.uint8))
        n = [0, 1, 2, 3, 6, 7, 9, 11][i % 8]
        if n == 0:
            rows.append(dict(filename=name, width=40, height=40, **{"class": "empty"},
                             xmin=0, ymin=0, xmax=0, ymax=0))
        for k in range(n):
            x, y = 2 + 3 * (k % 6), 2 + 9 * (k // 6)
            rows.append(dict(filename=name, width=40, height=40,
                             **{"class": ["car", "truck"][k % 2]},
                             xmin=x, ymin=y, xmax=x + 14, ymax=y + 12))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


def test_bootstrap_factors_and_indices_equal(toy_dir):
    for n in range(0, 14):
        assert bootstrap_repeats(n) == jax_bootstrap_repeats(n)
    got = bootstrap_indices(DetectionDataset(toy_dir))
    ref = jax_bootstrap_indices(JaxDataset(toy_dir))
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 22


def _compare_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.count == r.count
        np.testing.assert_allclose(g.batch.images.numpy(), np.asarray(r.batch.images), atol=2e-5)
        np.testing.assert_allclose(g.batch.gt_boxes.numpy(), np.asarray(r.batch.gt_boxes),
                                   atol=1e-5)
        np.testing.assert_array_equal(g.batch.gt_labels.numpy(), np.asarray(r.batch.gt_labels))
        np.testing.assert_array_equal(g.batch.gt_valid.numpy(), np.asarray(r.batch.gt_valid))


def _compare_epochs(torch_loader, jax_loader, epochs):
    assert len(torch_loader) == len(jax_loader)
    for _ in range(epochs):
        got, ref = list(torch_loader), list(jax_loader)
        assert len(got) == len(torch_loader)
        _compare_batches(got, ref)


def test_train_epoch_order_equals_jax(toy_dir):
    kw = dict(batch_size=8, train=True, source_size=40, num_workers=2, seed=11, bootstrap=True,
              prefetch=False)
    t = DetectionLoader(DetectionDataset(toy_dir), augment_cfg=AugmentConfig(**IDENTITY),
                        device="cpu", **kw)
    j = JaxLoader(JaxDataset(toy_dir), augment_cfg=JaxAugmentConfig(**IDENTITY), **kw)
    assert t.max_boxes == j.max_boxes == 11
    _compare_epochs(t, j, epochs=2)
    np.testing.assert_array_equal(t._epoch_indices(), j._epoch_indices())  # epoch 2's order


def test_a_loader_built_afresh_replays_epoch_0_as_a_resume_does(toy_dir):
    """Neither package stores the loader's epoch counter, and train.run builds
    its loader anew before it resumes from last.ckpt: after two epochs a new
    loader starts over at epoch 0's permutation of the bootstrap-repeated
    indices (and epoch 0's augmentation draws), in both packages alike."""
    kw = dict(batch_size=8, train=True, source_size=40, num_workers=2, seed=11, bootstrap=True,
              prefetch=False)
    mk = lambda: DetectionLoader(DetectionDataset(toy_dir), augment_cfg=AugmentConfig(**IDENTITY),
                                 device="cpu", **kw)
    t = mk()
    order0 = t._epoch_indices()
    epoch0 = list(t)
    list(t)
    assert not np.array_equal(t._epoch_indices(), order0)  # the running loader is at epoch 2
    fresh = mk()
    np.testing.assert_array_equal(fresh._epoch_indices(), order0)
    replay = list(fresh)
    assert len(replay) == len(epoch0) == len(t)
    for a, b in zip(replay, epoch0):
        for x, y in zip(a.batch, b.batch):
            assert torch.equal(x, y)
    j = JaxLoader(JaxDataset(toy_dir), augment_cfg=JaxAugmentConfig(**IDENTITY), **kw)
    np.testing.assert_array_equal(j._epoch_indices(), order0)
    _compare_batches(replay, list(j))


def test_eval_order_and_wrapped_tail_equal_jax(toy_dir):
    kw = dict(batch_size=8, train=False, num_workers=2, prefetch=True)  # native size: 40
    t = DetectionLoader(DetectionDataset(toy_dir), device="cpu", **kw)
    j = JaxLoader(JaxDataset(toy_dir), **kw)
    assert t.source_size == j.source_size == 40 and len(t) == 3
    _compare_epochs(t, j, epochs=1)
    tail = list(t)[-1]
    assert tail.count == 22 - 16 and tail.batch.images.shape[0] == 8
    first = next(iter(t))
    torch.testing.assert_close(tail.batch.images[6:], first.batch.images[:2])  # wrap-around


def test_prefetch_on_and_off_give_the_same_batches(toy_dir):
    ds = DetectionDataset(toy_dir)
    mk = lambda prefetch: DetectionLoader(ds, batch_size=4, train=True, source_size=40,
                                          num_workers=2, seed=5, bootstrap=True,
                                          prefetch=prefetch, device="cpu")
    on, off = mk(True), mk(False)
    for _ in range(2):  # the augmentation's generator advances alike in both
        a, b = list(on), list(off)
        assert len(a) == len(b) == len(on) > 0
        for x, y in zip(a, b):
            for s, t in zip(x.batch, y.batch):
                assert torch.equal(s, t)
    assert a[0].batch.images.shape == (4, 300, 300, 3) and a[0].batch.images.dtype == torch.float32


def test_early_break_reaps_producer(toy_dir):
    loader = DetectionLoader(DetectionDataset(toy_dir), batch_size=4, train=False,
                             source_size=40, num_workers=2, prefetch=True, device="cpu")
    for _ in range(3):
        it = iter(loader)
        next(it)  # consume one batch, then abandon the iterator
        it.close()
    assert [t for t in threading.enumerate() if t.name == "ssdx-prefetch"] == []
    assert len(list(loader)) == len(loader)  # still usable


def test_producer_error_reaches_the_consumer(toy_dir):
    class Broken(DetectionDataset):
        def load_image(self, index):
            raise IOError("cannot decode")

    loader = DetectionLoader(Broken(toy_dir), batch_size=4, train=False, source_size=40,
                             num_workers=2, prefetch=True, device="cpu")
    with pytest.raises(IOError, match="cannot decode"):
        list(loader)
    assert [t for t in threading.enumerate() if t.name == "ssdx-prefetch"] == []


def test_cache_and_max_boxes(toy_dir):
    ds = DetectionDataset(toy_dir)
    cached = DetectionLoader(ds, batch_size=8, train=False, num_workers=2, prefetch=False,
                             cache_images=True, device="cpu")
    e1 = [b.batch.images for b in cached]
    e2 = [b.batch.images for b in cached]
    assert cached.stats["decoded"] == len(ds)  # the second epoch hits the cache
    assert all(torch.equal(a, b) for a, b in zip(e1, e2))
    with pytest.warns(UserWarning, match="truncated"):
        small = DetectionLoader(ds, batch_size=8, train=False, max_boxes=4, num_workers=1,
                                prefetch=False, device="cpu")
    with pytest.warns(UserWarning, match="truncating"):
        list(small)


def test_loader_needs_a_gpu_unless_asked_for_the_cpu(toy_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        DetectionLoader(DetectionDataset(toy_dir), batch_size=4, train=False)
