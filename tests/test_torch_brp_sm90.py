"""CPU model of the BN + ReLU + pool kernels B6's Hopper design
(csrc/bn_relu_pool.cu), which runs only on the card.

The model walks pipe_kernel as it runs, from the geometry that the wrapper
launches it with (``ops.bn_relu_pool.tiles``): persistent blocks take the
bands blockIdx.x, blockIdx.x + grid, ..., each band's tiles in order; the
producer copies a tile's two input rows (and the pooled columns of g) and
consumer thread (slot, cg) takes window ``slot`` of each tile.  Checked:
every pixel (stats, dx) and every pooled window (apply, reduce) is taken
exactly once, in floor and ceil mode and at odd H and W, and only from
bytes the producer copied; dx, written over the tile's x, covers every byte
that the producer then copies out; each band's partial row has one summation order,
so it comes out bit for bit the same whatever the grid; the four passes and
the two finalize kernels, in float32 in the kernels' order, give the plain
version's outputs; the tiles fit the source's ring for every C the
contract takes.  And the plain version itself still equals the JAX
package's function at the four ``BRP_CASES`` shapes of
``tools/check_brp.py``, scaled down.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx.ops.fused_bn_pool import bn_relu_pool as jax_brp
from ssdx_torch.ops import bn_relu_pool as brp
from ssdx_torch.tools.check_brp import BRP_CASES

SRC = (Path(__file__).resolve().parents[1] / "ssdx_torch" / "csrc" / "bn_relu_pool.cu").read_text()
f32 = np.float32


def _const(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return m.group(1)


CONSUMERS, ROW_ELEMS = int(_const("kConsumers")), int(_const("kRowElems"))
RING = int(_const("kRingBytes"))
STAGE_ELEMS = 2 * ROW_ELEMS + ROW_ELEMS // 2
RED_STRIDE = int(_const("kRedStride"))
SMEM = 128 + RING + CONSUMERS * RED_STRIDE * 4
GRIDS = (1, 3, 7, 2 * 114, 2 * 132)  # and the H100 PCIe's and SXM's persistent grids


def walk(t, grid):
    """Per block, its tiles (band, q) in the order it reads them."""
    return [[(band, q) for band in range(blk, t["nbands"], grid) for q in range(t["nq"])]
            for blk in range(grid)]


def tile(t, band, q):
    """The windows a tile's consumers take: (b, P, Q [slots], in [slots, 4],
    the producer's copies as (row bytes, rows, g bytes))."""
    b, P = divmod(band, t["bands"])
    H, W, C, Hp, Wp = t["H"], t["W"], t["C"], t["Hp"], t["Wp"]
    Q = q * t["slots"] + np.arange(t["slots"])
    rows = np.array([2 * P + (i >> 1) for i in range(4)])
    cols = 2 * Q[:, None] + np.array([i & 1 for i in range(4)])[None, :]
    inside = (rows[None, :] < H) & (cols < W) & (2 * Q[:, None] < W)
    ncol = min(t["tw"], W - q * t["tw"])
    g_cols = min(t["slots"], Wp - q * t["slots"]) if P < Hp else 0
    return b, P, Q, inside, cols, (ncol * C, 2 if 2 * P + 1 < H else 1, max(g_cols, 0) * C)


SHAPES = [(2, 7, 9, 16, False), (2, 7, 9, 16, True), (1, 5, 130, 64, False),
          (3, 6, 70, 128, True), (1, 1, 1, 8, False), (1, 1, 3, 8, True), (2, 4, 41, 24, False),
          (1, 3, 5, 2048, True)]


@pytest.mark.parametrize("B,H,W,C,ceil", SHAPES)
def test_every_pixel_and_window_once(B, H, W, C, ceil):
    Hp, Wp = (H + 1) // 2 if ceil else H // 2, (W + 1) // 2 if ceil else W // 2
    for mode in ("stats", "dx", "apply", "reduce"):
        t = brp.tiles(B, H, W, C, ceil, mode)
        assert t["tw"] * C <= ROW_ELEMS and t["slots"] * C <= ROW_ELEMS // 2
        seen_pix, seen_win = [], []
        for blocks in walk(t, 5):
            for band, q in blocks:
                b, P, Q, inside, cols, (row_elems, nrows, g_elems) = tile(t, band, q)
                written = set()
                for s in range(t["slots"]):
                    for i in range(4):
                        if inside[s, i]:
                            # read from the copied bytes only: local column < ncol, row < nrows
                            assert (2 * s + (i & 1)) * C < row_elems and (i >> 1) < nrows
                            seen_pix.append((b, 2 * P + (i >> 1), int(cols[s, i])))
                            written.add((i >> 1, 2 * s + (i & 1)))
                    if 2 * Q[s] < W and P < Hp and Q[s] < Wp:
                        if mode in ("reduce", "dx"):
                            assert (s + 1) * C <= g_elems  # its g was copied
                        seen_win.append((b, P, int(Q[s])))
                if mode == "dx":  # dx overwrites every element of the rows the producer copies out
                    assert written == {(r, c) for r in range(nrows) for c in range(row_elems // C)}
        pixels = {(b, r, c) for b in range(B) for r in range(H) for c in range(W)}
        pooled = {(b, P, Q) for b in range(B) for P in range(Hp) for Q in range(Wp)}
        if mode in ("stats", "dx"):
            assert sorted(seen_pix) == sorted(pixels)  # each pixel exactly once
            assert sorted(seen_win) == sorted(pooled)
        else:
            assert sorted(seen_win) == sorted(pooled)  # each pooled window exactly once
            assert len(set(seen_pix)) == len(seen_pix)


# ---------------------------------------------------- the kernels in float32


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def bn_relu(v, a, c):
    return np.maximum((v * a).astype(f32) + c, f32(0))


def pipe(mode, x, t, grid, vec=None, fin=None, g=None, tie_split=True):
    """pipe_kernel<float, mode> over ``grid`` blocks: part rows (stats,
    reduce) or the output (apply: p, dx: dx)."""
    B, H, W, C, Hp, Wp, S = t["B"], t["H"], t["W"], t["C"], t["Hp"], t["Wp"], t["slots"]
    part = np.full((t["nbands"], 2 * C), np.nan, f32)
    out = np.full((B, Hp, Wp, C) if mode == "apply" else x.shape, np.nan, f32)
    for blocks in walk(t, grid):
        for n, (band, q) in enumerate(blocks):
            b, P, Q, inside, cols, _ = tile(t, band, q)
            if q == 0:
                s1, s2 = np.zeros((S, C), f32), np.zeros((S, C), f32)
            v = np.zeros((S, 4, C), f32)
            for i in range(4):
                ok = inside[:, i]
                if ok.any():
                    v[ok, i] = x[b, 2 * P + (i >> 1), cols[ok, i]]
            if mode == "stats":
                for i in range(4):
                    ok = inside[:, i][:, None]
                    s1 = np.where(ok, s1 + v[:, i], s1)
                    s2 = np.where(ok, fma(v[:, i], v[:, i], s2), s2)
            elif mode == "apply":
                y = np.where(inside[:, :, None], bn_relu(v, vec[0], vec[1]), -np.inf)
                ok = (2 * Q < W) & (Q < Wp)
                out[b, P, Q[ok]] = y.max(axis=1)[ok]
            else:
                pooled = (2 * Q < W) & (P < Hp) & (Q < Wp)
                y = np.where(inside[:, :, None], bn_relu(v, vec[0], vec[1]), f32(-np.inf))
                pm = y.max(axis=1, keepdims=True)
                hit = (y == pm) & (pm > 0) & pooled[:, None, None]
                gg = np.zeros((S, C), f32)
                if pooled.any():
                    gg[pooled] = g[b, P, Q[pooled]]
                cnt = hit.sum(axis=1, keepdims=True)
                share = (gg[:, None] / np.maximum(cnt, 1).astype(f32)).astype(f32) if tie_split \
                    else np.broadcast_to(gg[:, None], hit.shape)
                d = np.where(hit, share, f32(0))
                if mode == "reduce":  # s2 = sum share * (x - mu) over the hits; inv at the end
                    xm = np.where(hit & inside[:, :, None], (v - vec[3]).astype(f32), f32(0))
                    tsum = np.zeros((S, C), f32)
                    for i in range(4):
                        tsum = tsum + xm[:, i]
                    sh = np.where(pm[:, 0] > 0, share[:, 0], f32(0))
                    s1 = fma(sh, cnt[:, 0].astype(f32), s1)
                    s2 = fma(sh, tsum, s2)
                else:
                    for i in range(4):
                        ok = inside[:, i]
                        if not ok.any():
                            continue
                        xm = (v[:, i] - vec[3]).astype(f32)
                        r = fma(vec[0], d[:, i], fma(xm, fin[2], fin[3]))
                        out[b, 2 * P + (i >> 1), cols[ok, i]] = r[ok]
            last = n + 1 == len(blocks) or blocks[n + 1][0] != band
            if last and mode in ("stats", "reduce"):
                acc = np.zeros((2, C), f32)
                for j in range(S):  # the slots, in order
                    acc[0] += s1[j]
                    acc[1] += s2[j]
                part[band] = acc.reshape(-1)
    return part if mode in ("stats", "reduce") else out


FIN_GROUPS = 1024 // (2 * int(_const("kFinChannels")))


def column_sums(part):
    """The finalize kernels' fixed tree: group k of FIN_GROUPS adds rows k,
    k + FIN_GROUPS, ... in order, then the group sums are added pairwise."""
    n = part.shape[0]
    groups = np.zeros((FIN_GROUPS, part.shape[1]), f32)
    for k in range(FIN_GROUPS):
        for row in range(k, n, FIN_GROUPS):
            groups[k] += part[row]
    stride = FIN_GROUPS // 2
    while stride:
        groups[:stride] += groups[stride:2 * stride]
        stride //= 2
    return groups[0]


def model(x, gamma, beta, gp, gmean, gvar, ceil, tie_split, grid, eps=1e-5):
    B, H, W, C = x.shape
    n = f32(B * H * W)
    t = {m: brp.tiles(B, H, W, C, ceil, m) for m in ("stats", "apply", "reduce", "dx")}
    sums = column_sums(pipe("stats", x, t["stats"], grid))
    mu = sums[:C] / n
    var = np.maximum(sums[C:] / n - mu * mu, f32(0))
    inv = (1 / np.sqrt(var.astype(np.float64) + eps)).astype(f32)
    a = gamma * inv
    vec = np.stack([a, beta - mu * a, inv, mu]).astype(f32)
    p = pipe("apply", x, t["apply"], grid, vec=vec)
    sums = column_sums(pipe("reduce", x, t["reduce"], grid, vec=vec, g=gp, tie_split=tie_split))
    s1, s2 = sums[:C], sums[C:] * inv
    fin = np.stack([s1, s2, gvar * (2 / n) - a * inv * (s2 / n), gmean / n - a * (s1 / n)])
    dx = pipe("dx", x, t["dx"], grid, vec=vec, fin=fin.astype(f32), g=gp, tie_split=tie_split)
    return p, mu, var, dx, s2, s1


def inputs(shape, ceil, seed, ties=False):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = rng.normal(size=shape).astype(f32)
    if ties:
        x = np.round(x * 2) / 2
    Hp, Wp = ((H + 1) // 2, (W + 1) // 2) if ceil else (H // 2, W // 2)
    return (x, rng.normal(1, 0.2, C).astype(f32), rng.normal(0, 0.2, C).astype(f32),
            rng.normal(size=(B, Hp, Wp, C)).astype(f32), rng.normal(size=C).astype(f32),
            rng.normal(size=C).astype(f32))


@pytest.mark.parametrize("shape,ceil,ties", [((2, 10, 130, 64), False, False),
                                             ((2, 5, 37, 24), True, True)])
def test_partial_rows_do_not_depend_on_the_grid(shape, ceil, ties):
    x, gamma, beta, gp, gmean, gvar = inputs(shape, ceil, 1, ties)
    runs = [model(x, gamma, beta, gp, gmean, gvar, ceil, True, grid) for grid in GRIDS]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert a.tobytes() == b.tobytes()  # bit for bit


@pytest.mark.parametrize("tie_split", [True, False])
@pytest.mark.parametrize("shape,ceil,ties", [((2, 10, 130, 64), False, False),
                                             ((2, 8, 70, 128), False, False),
                                             ((2, 7, 37, 256), True, False),
                                             ((1, 9, 67, 64), False, True),
                                             ((3, 9, 11, 24), True, True)])
def test_model_equals_plain_version(shape, ceil, ties, tie_split):
    """The modelled passes (float32, the kernels' order) against
    bn_relu_pool_ref: phase 15's limits, tighter for float32 inputs."""
    x, gamma, beta, gp, gmean, gvar = inputs(shape, ceil, 2, ties)
    p, mu, var, dx, dgamma, dbeta = model(x, gamma, beta, gp, gmean, gvar, ceil, tie_split, 7)
    xt = torch.as_tensor(x).requires_grad_()
    gt, bt = torch.as_tensor(gamma).requires_grad_(), torch.as_tensor(beta).requires_grad_()
    rp, rmu, rvar = brp.bn_relu_pool_ref(xt, gt, bt, 1e-5, ceil, tie_split)
    torch.autograd.backward((rp, rmu, rvar), tuple(torch.as_tensor(a) for a in (gp, gmean, gvar)))
    rel = lambda k, r: np.abs(k - r).max() / (np.abs(r).max() + 1e-12)
    assert not np.isnan(p).any() and not np.isnan(dx).any()  # every output element written
    assert rel(p, rp.detach().numpy()) < 1e-5
    assert rel(mu, rmu.detach().numpy()) < 1e-5 and rel(var, rvar.detach().numpy()) < 1e-5
    r = xt.grad.numpy()
    assert np.linalg.norm(dx - r) / np.linalg.norm(r) < 1e-4
    assert rel(dgamma, gt.grad.numpy()) < 1e-4 and rel(dbeta, bt.grad.numpy()) < 1e-4


def test_ring_and_tiles_fit_every_channel_count():
    """For every C % 8 == 0 up to 2048 a tile's rows and g fit a stage; the
    ring holds 4 stages in bfloat16 and 2 in float32; every bulk copy is a
    whole number of 16 bytes; with the dx pass's five rows of per-channel
    vectors two blocks fit an SM's 227 KB up to C = 512, and one block up
    to C = 2048."""
    for itemsize, stages in ((2, 4), (4, 2)):
        assert RING // (STAGE_ELEMS * itemsize) == stages
    smem = lambda C: SMEM + 5 * C * 4
    sm_bytes, per_block = 232448, 1024  # an H100 SM's shared memory, and its reserve per block
    assert 2 * (smem(512) + per_block) <= sm_bytes
    assert smem(int(_const("kMaxC"))) + per_block <= sm_bytes and int(_const("kMaxC")) == 2048
    assert f"__launch_bounds__(kBlock, {brp._BLOCKS_PER_SM})" in SRC
    assert CONSUMERS == brp._CONSUMERS
    for C in range(8, 2049, 8):
        t = brp.tiles(1, 3, 1000, C, True, "dx")
        assert t["tw"] % 2 == 0 and t["tw"] * C <= ROW_ELEMS and t["slots"] * C <= ROW_ELEMS // 2
        assert t["slots"] * t["G"] <= CONSUMERS
        for itemsize in (2, 4):
            assert (C * itemsize) % 16 == 0  # a pixel, so every row and g copy


def test_no_pooled_window_launches_no_reduce_or_apply():
    """Floor mode on one row or one column pools nothing: apply and reduce
    have no bands (the wrapper launches neither), stats and dx still walk
    every pixel."""
    for shape in ((2, 1, 9, 16), (2, 6, 1, 16)):
        for mode, want in (("apply", 0), ("reduce", 0), ("stats", 2 * ((shape[1] + 1) // 2)),
                           ("dx", 2 * ((shape[1] + 1) // 2))):
            assert brp.tiles(*shape, False, mode)["nbands"] == want


@pytest.mark.parametrize("shape,ceil,ties", BRP_CASES)
def test_plain_version_unchanged_at_scaled_down_cases(shape, ceil, ties):
    """bn_relu_pool_ref against the JAX package's bn_relu_pool (XLA path) at
    each BRP_CASES shape cut to 2 images and about a tenth of the rows and
    columns (odd in ceil mode; even in floor mode, the only sizes the JAX
    function's floor path takes), float32, loss over all three outputs:
    within 1e-5, as tests/test_torch_bn_relu_pool.py holds them."""
    B, H, W, C = shape
    cut = lambda n: max(3, n // 10) | 1 if ceil else max(4, n // 10) & ~1
    small = (2, cut(H), cut(W), C)
    x, gamma, beta, *_ = inputs(small, ceil, 3, ties)

    def jax_loss(a):
        p, mean, var = jax_brp(*a, 1e-5, ceil, True, "xla")
        return jnp.sum(p ** 2) + jnp.sum(mean * jnp.arange(C, dtype=mean.dtype)) \
            + jnp.sum(var * 0.5), (p, mean, var)

    (_, outs), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    xt = torch.as_tensor(x).requires_grad_()
    gt, bt = torch.as_tensor(gamma).requires_grad_(), torch.as_tensor(beta).requires_grad_()
    p, mean, var = brp.bn_relu_pool_ref(xt, gt, bt, 1e-5, ceil, True)
    ((p ** 2).sum() + (mean * torch.arange(C)).sum() + (var * 0.5).sum()).backward()
    for k, r in zip((p, mean, var), outs):
        assert np.abs(k.detach().numpy() - np.asarray(r)).max() <= 1e-5
    for k, r in zip((xt.grad, gt.grad, bt.grad), grads):
        r = np.asarray(r)
        assert np.abs(k.numpy() - r).max() <= 1e-5 * (np.abs(r).max() + 1e-6)
    assert math.prod(p.shape) > 0
