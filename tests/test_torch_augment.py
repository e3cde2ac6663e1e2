"""The port's augmentation (ssdx_torch.data.augment) against the JAX package's.

The deterministic core is held to ``ssdx.data.augment`` on equal random
numbers: the JAX functions are run un-jitted with ``jax.random`` replaced, in
that module only, by a table of the same uniforms the port's
:class:`AugmentDraws` holds.  Everything is float32 on both sides: each op must
agree within 1e-5, the whole chain's normalized image within 1e-4, and
windows in source pixels within 1e-3 of a pixel at 512 px.  The sampler itself (``sample_draws`` + ``select_iou_crop``) is
held by the distributional checks of tests/test_augment_semantics.py, with
the same limits.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdx.data.augment as jaug
from ssdx_torch.data import augment as taug

ATOL = 1e-5
# the whole chain on normalized images (range about -2.1 .. 2.6): the hue round
# trip multiplies float32 rounding by 6 and the normalization by 1/std = 4.4
CHAIN_ATOL = 1e-4


class TableRandom:
    """Stands in for ``jax.random``: keys are tuples, ``split`` appends an
    index, and every draw is looked up in ``table`` by its key."""

    def __init__(self, table):
        self.table = table

    def split(self, key, num=2):
        return [key + (i,) for i in range(num)]

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(self.table[key], jnp.float32).reshape(shape)
        return u * (maxval - minval) + minval

    def randint(self, key, shape, minval, maxval):
        u = jnp.asarray(self.table[key], jnp.float32).reshape(shape)
        n = maxval - minval
        return jnp.minimum(jnp.floor(u * n).astype(jnp.int32), n - 1) + minval

    def permutation(self, key, n):
        return jnp.asarray(self.table[key], jnp.int32)


def _table(d: taug.AugmentDraws, b: int, root=("k",)) -> dict:
    """Image ``b``'s draws under the keys ``_augment_one`` derives from ``root``."""
    n = lambda t: t.numpy()
    win, flip, photo = root + (0,), root + (1,), root + (2,)
    t = {win + (i,): n(d.zoom[b, i]) for i in range(4)}
    for k in (0, 1):  # small, large policy: keys 4 and 5 of the window's split
        crop = win + (4 + k,)
        t[crop + (0,)] = n(d.crop_opt[b, k])
        for q in range(4):
            t[crop + (1 + q,)] = n(d.crop_u[b, k, q])
    t[flip] = n(d.flip[b])
    t[photo + (0,)] = n(d.photo_gate[b, :6])
    for q in range(4):
        t[photo + (1 + q,)] = n(d.photo_f[b, q])
    t[photo + (5,)] = n(d.perm[b])
    t[photo + (6,)] = n(d.photo_gate[b, 6])
    return t


@pytest.fixture
def jax_with_table(monkeypatch):
    """Install a TableRandom as ``jax.random`` inside ssdx.data.augment."""
    def install(table):
        shim = types.SimpleNamespace(random=TableRandom(table), vmap=jax.vmap, image=jax.image)
        monkeypatch.setattr(jaug, "jax", shim)
    return install


def _batch(rng, B, S, G):
    imgs = rng.integers(0, 255, (B, S, S, 3), np.uint8)
    lo = rng.uniform(0, S * 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(S * 0.05, S * 0.35, (B, G, 2)).astype(np.float32)
    boxes = np.concatenate([lo, np.minimum(lo + sz, S)], -1)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    valid = rng.random((B, G)) < 0.8
    valid[0] = False  # one image without boxes: no crop
    return imgs, boxes, labels, valid


def _draws(seed, B, cfg):
    return taug.sample_draws(torch.Generator().manual_seed(seed), B, cfg, "cpu")


CFGS = {
    "default": taug.AugmentConfig(),
    "zoom": taug.AugmentConfig(zoom_out_prob=0.7, photometric_prob=0.9),
    "always": taug.AugmentConfig(zoom_out_prob=1.0, hflip_prob=1.0, photometric_prob=1.0),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_augment_core_equals_jax_on_equal_draws(jax_with_table, name):
    """The whole chain for one image at a time: window, boxes and their
    validity, resample, flip, photometric distort, normalize."""
    cfg = CFGS[name]
    jcfg = jaug.AugmentConfig(**cfg._asdict())
    B, S, G, out = 6, 64, 5, 48
    imgs, boxes, labels, valid = _batch(np.random.default_rng(1), B, S, G)
    d = _draws(7, B, cfg)
    t_img, t_box, t_lab, t_val = taug.augment_core(
        torch.as_tensor(imgs), torch.as_tensor(boxes), torch.as_tensor(labels),
        torch.as_tensor(valid), d, cfg, out)
    crops = 0
    for b in range(B):
        jax_with_table(_table(d, b))
        j_img, j_box, j_lab, j_val = jaug._augment_one(
            ("k",), jnp.asarray(imgs[b]), jnp.asarray(boxes[b]), jnp.asarray(labels[b]),
            jnp.asarray(valid[b]), jcfg, out)
        np.testing.assert_array_equal(t_val[b].numpy(), np.asarray(j_val))
        np.testing.assert_array_equal(t_lab[b].numpy(), np.asarray(j_lab))
        np.testing.assert_allclose(t_box[b].numpy(), np.asarray(j_box), atol=ATOL)
        np.testing.assert_allclose(t_img[b].numpy(), np.asarray(j_img), atol=CHAIN_ATOL)
        win = jaug._sample_window(("k", 0), jnp.float32(S), jnp.asarray(boxes[b]),
                                  jnp.asarray(labels[b]), jnp.asarray(valid[b]), jcfg)
        crops += int(not np.allclose(np.asarray(win), [0, 0, S, S]))
    assert crops >= 2  # the draws exercise real windows, not only the identity
    assert torch.isfinite(t_img).all() and t_img.shape == (B, out, out, 3)


def test_select_windows_equals_jax_on_equal_draws(jax_with_table):
    """Windows alone, over many draws with zoom-out on (every branch of the
    round and candidate selection), in source pixels within 1e-3."""
    cfg = taug.AugmentConfig(zoom_out_prob=0.5)
    jcfg = jaug.AugmentConfig(**cfg._asdict())
    B, S, G = 48, 512, 6
    _, boxes, labels, valid = _batch(np.random.default_rng(2), B, S, G)
    d = _draws(3, B, cfg)
    got = taug.select_windows(S, torch.as_tensor(boxes), torch.as_tensor(valid), d, cfg).numpy()
    kinds = set()
    for b in range(B):
        jax_with_table(_table(d, b))
        ref = np.asarray(jaug._sample_window(("k", 0), jnp.float32(S), jnp.asarray(boxes[b]),
                                             jnp.asarray(labels[b]), jnp.asarray(valid[b]),
                                             jcfg))
        np.testing.assert_allclose(got[b], ref, atol=1e-3)
        side = ref[2] - ref[0]
        kinds.add("zoomed" if side > S + 1 else "identity" if abs(side - S) < 1e-3 else "crop")
    assert kinds == {"zoomed", "identity", "crop"}


@pytest.mark.parametrize("win", [(0.0, 0.0, 64.0, 64.0), (10.5, 3.25, 50.0, 40.0),
                                 (-20.0, -8.0, 90.0, 100.0), (5.0, 5.0, 25.0, 20.0)])
def test_resample_equals_jax_for_a_given_window(win):
    """Identity, a crop (downscale), a zoomed-out canvas (zero fill outside
    the source) and an upscale."""
    img = np.random.default_rng(3).random((64, 64, 3)).astype(np.float32)
    ref = np.asarray(jaug._resample_to_output(jnp.asarray(img), jnp.asarray(win, jnp.float32), 48))
    got = taug.resample(torch.as_tensor(img)[None], torch.tensor([win]), 48)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_color_ops_equal_jax():
    rng = np.random.default_rng(4)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    img[0, :4] = img[0, :4, :, :1]  # grey pixels: zero saturation
    img[1, :2] = 0.0
    f = np.array([0.6, 1.4], np.float32)
    ti, tf = torch.as_tensor(img), torch.as_tensor(f)
    for name in ("_adjust_brightness", "_adjust_contrast", "_adjust_saturation"):
        got = getattr(taug, name)(ti, tf).numpy()
        ref = np.stack([np.asarray(getattr(jaug, name)(jnp.asarray(img[b]), f[b]))
                        for b in range(2)])
        np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=name)
    delta = np.array([-0.05, 0.04], np.float32)
    got = taug._adjust_hue(ti, torch.as_tensor(delta)).numpy()
    ref = np.stack([np.asarray(jaug._adjust_hue(jnp.asarray(img[b]), delta[b])) for b in range(2)])
    np.testing.assert_allclose(got, ref, atol=ATOL)
    h, s, v = taug._rgb_to_hsv(ti)
    jh, js, jv = jaug._rgb_to_hsv(jnp.asarray(img))
    for a, b in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(taug._hsv_to_rgb(h, s, v).numpy(), img, atol=ATOL)  # round trip


def test_preprocess_batch_equals_jax():
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 255, (2, 80, 80, 3), np.uint8)
    boxes = rng.uniform(0, 80, (2, 3, 4)).astype(np.float32)
    j_img, j_box = jaug.preprocess_batch(jnp.asarray(imgs), jnp.asarray(boxes))
    t_img, t_box = taug.preprocess_batch(torch.as_tensor(imgs), torch.as_tensor(boxes))
    # the weight matrices are equal bit for bit; XLA's CPU einsum is 3.4e-6 off
    # the float64 product here (the port 1e-7), and 1/std multiplies that by 4.4
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=2e-5)
    np.testing.assert_allclose(t_box.numpy(), np.asarray(j_box), atol=ATOL)
    assert t_img.shape == (2, 300, 300, 3)


def test_identity_config_matches_preprocess_and_keeps_boxes():
    rng = np.random.default_rng(6)
    imgs, boxes, labels, valid = _batch(rng, 2, 64, 4)
    valid[:] = True
    cfg = taug.AugmentConfig(small_sampler_options=(2.0,), large_sampler_options=(2.0,),
                             hflip_prob=0.0, photometric_prob=0.0)
    args = [torch.as_tensor(a) for a in (imgs, boxes, labels, valid)]
    img, b01, lab, val = taug.augment_batch(torch.Generator().manual_seed(0), *args, cfg)
    p_img, p_box = taug.preprocess_batch(args[0], args[1])
    torch.testing.assert_close(img, p_img, atol=ATOL, rtol=0)
    torch.testing.assert_close(b01, p_box, atol=ATOL, rtol=0)
    assert val.all() and torch.equal(lab, args[2])


# ---- the sampler, by distribution (tests/test_augment_semantics.py) ----

from test_augment_semantics import CFG, SIZE, _host_iou_crop, _random_boxes, _stats  # noqa: E402


@pytest.mark.parametrize("policy", ["small", "large"])
def test_crop_distribution_matches_host_loop(policy):
    n, G = 400, 8
    cfg = taug.AugmentConfig()
    min_scale = CFG.small_min_scale if policy == "small" else CFG.large_min_scale
    options = CFG.small_sampler_options if policy == "small" else CFG.large_sampler_options
    rng = np.random.default_rng(11)
    box_sets = [_random_boxes(rng, int(rng.integers(1, 6))) for _ in range(n)]
    host = [_host_iou_crop(np.random.default_rng(1000 + i), SIZE, box_sets[i], min_scale,
                           np.asarray(options), CFG)[0] for i in range(n)]
    boxes, valid = np.zeros((n, G, 4), np.float32), np.zeros((n, G), bool)
    for i, bs in enumerate(box_sets):
        boxes[i, :len(bs)], valid[i, :len(bs)] = bs, True
    d = _draws(3, n, cfg)
    k = 0 if policy == "small" else 1
    wins = taug.select_iou_crop(torch.full((n,), SIZE), torch.as_tensor(boxes),
                                torch.as_tensor(valid), min_scale, options, d.crop_opt[:, k],
                                d.crop_u[:, k], cfg).numpy()
    rate_h, frac_h = _stats(host)
    rate_t, frac_t = _stats(wins)
    # binomial std error at n=400 is ~2.5%; the JAX test's bands
    assert abs(rate_h - rate_t) < 0.10, (rate_h, rate_t)
    assert abs(frac_h - frac_t) < 0.08, (frac_h, frac_t)


def test_sentinel_only_options_give_identity():
    cfg = taug.AugmentConfig()
    d = _draws(0, 1, cfg)
    win = taug.select_iou_crop(torch.tensor([SIZE]), torch.tensor([[[100.0, 100.0, 200.0, 200.0]]]),
                               torch.tensor([[True]]), 0.3, (2.0,), d.crop_opt[:, 0],
                               d.crop_u[:, 0], cfg)
    np.testing.assert_allclose(win.numpy(), [[0, 0, SIZE, SIZE]])


def test_sample_draws_are_uniform_and_seeded():
    cfg = taug.AugmentConfig()
    a, b = _draws(5, 512, cfg), _draws(5, 512, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.flip, _draws(6, 512, cfg).flip)
    for t in (a.zoom, a.crop_u, a.flip, a.photo_gate, a.photo_f):
        assert 0.0 <= float(t.min()) and float(t.max()) < 1.0
        assert abs(float(t.mean()) - 0.5) < 0.05
    assert torch.equal(a.perm.sort(dim=1).values, torch.arange(3).expand(512, 3))
    first = torch.bincount(a.perm[:, 0], minlength=3) / 512.0
    assert (first - 1 / 3).abs().max() < 0.07  # each channel leads about a third of the time


def test_crop_keeps_at_least_one_box():
    rng = np.random.default_rng(3)
    imgs, boxes, labels, valid = _batch(rng, 8, 64, 4)
    valid[:] = True
    args = [torch.as_tensor(a) for a in (imgs, boxes, labels, valid)]
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        _, b01, _, v = taug.augment_batch(gen, *args, taug.AugmentConfig(photometric_prob=0.0))
        assert v.any(dim=1).all()
        assert float(b01.min()) >= 0 and float(b01.max()) <= 1
