"""CPU model of the stem kernels' wgmma core (csrc/stem_sm90.cuh, stem.cu,
stem_train.cu), which runs only on the card.

Shared memory is modelled as flat float64 arrays in the byte layout the
kernels write (the weights' 16-byte chunks, the halo's chunk-major pixels,
the im2col and the dy2 and dy1 tiles), and every wgmma is modelled by
gathering its A and B operands through the descriptor fields the kernels
pass: start address, leading byte offset (LBO) and stride byte offset (SBO)
of the no-swizzle layout, K-major or MN-major.  Tile by tile, as the
persistent blocks walk them, the contractions are held against ``F.conv2d``
(and its input and weight gradients) in float64, on maps whose edges fall
inside a tile: the 64 -> 64 core (stage2, dw2, B2's conv1_2) and conv1_1's
im2col (B2's y1 halo, B3's conv1_stats and dw1).  Plus: the accumulator
fragments behind the epilogues, the persistent work split, the sources'
instructions and exported symbols.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssdx_torch.ops import stem as stem_ops

CSRC = Path(__file__).resolve().parents[1] / "ssdx_torch" / "csrc"
CORE = (CSRC / "stem_sm90.cuh").read_text()


def _const(name, text=CORE):
    m = re.search(rf"constexpr int [^;]*\b{name} = ([^;]+);", text)
    assert m, name
    return m.group(1)


TR, TW, HW = int(_const("TR")), int(_const("TW")), int(_const("HW"))
HR = TR + 2
HALO_PIX = HR * HW
HALO_LD = int(_const("HALO_LD"))
N_WG = 128
C = 64
TRAIN = (CSRC / "stem_train.cu").read_text()
DY_LD = int(_const("kDyLd", TRAIN))
X_LD = int(_const("X_LD"))
# conv1_1's im2col: B2 builds the y1 halo (HR rows from r0 - 1, window rows
# from r0 - 2; two warpgroups of three m64 tiles), B3 the tile's own TR rows
# (window rows from r0 - 1; four warpgroups of one); slot hc is column
# c0 - 1 + hc, and ROWS * 64 pixels lie between its k-chunks.
CONV1 = {"b2": {"rows": HR, "wgs": 2, "tiles": 3},
         "b3": {"rows": TR, "wgs": 4, "tiles": 1}}
IM_LD = HALO_PIX  # stem.cu: kImLd


# ------------------------------------------------------------ the wgmma model


def gather(mem, start, lbo, sbo, rows, mn_major):
    """The ``rows`` x 16 bf16 operand a no-swizzle descriptor describes in
    ``mem`` (element-addressed, 2 bytes each; offsets in bytes).  K-major:
    row i of a core matrix 16 bytes after row i-1, the second 8 k at +LBO,
    the next 8 rows at +SBO.  MN-major: 8 rows (M or N) contiguous, k rows
    16 bytes apart, the next 8 k at +LBO, the next 8 rows at +SBO."""
    assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
    i = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    if mn_major:
        off = start + (i // 8) * sbo + (i % 8) * 2 + (k // 8) * lbo + (k % 8) * 16
    else:
        off = start + (i // 8) * sbo + (i % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    assert off.min() >= 0 and off.max() // 2 < mem.size
    return mem[off // 2]


def wgmma(d, a, b):
    """d (M x N) += A (M x 16) . B (N x 16)^T."""
    d += a @ b.T


# ------------------------------------------------------------ layouts


def stage_weights(a):
    """[64][576] -> the kernels' weight layout: chunk kc of row m at
    kc * 1024 + m * 16 bytes."""
    mem = np.zeros(a.shape[1] * C)
    for m in range(C):
        for kc in range(a.shape[1] // 8):
            mem[(kc * 1024 + m * 16) // 2 + np.arange(8)] = a[m, kc * 8:kc * 8 + 8]
    return mem


def tile_origins(H, W):
    """(r0, c0) of each tile of an H x W map, in the kernels' order."""
    tiles_x = -(-W // TW)
    return [(ty * TR, tx * TW) for ty in range(-(-H // TR)) for tx in range(tiles_x)]


def stage_halo(src, r0, c0):
    """The halo of tile (r0, c0) of ``src`` [64, H, W]: chunk c of pixel
    p = hr * 64 + hc at (c * HALO_LD + p) * 16 bytes, zero outside the map
    and in the padding."""
    _, H, W = src.shape
    mem = np.zeros(8 * HALO_LD * 8)
    for p in range(HALO_PIX):
        gr, gc = r0 - 1 + p // HW, c0 - 1 + p % HW
        if 0 <= gr < H and 0 <= gc < W:
            for c in range(8):
                mem[(c * HALO_LD + p) * 8 + np.arange(8)] = src[c * 8:c * 8 + 8, gr, gc]
    return mem


def core_conv(w_mem, halo, wg):
    """conv_taps<0, 9> of stem_sm90.cuh for warpgroup wg: D [64 co][128 columns]."""
    d = np.zeros((C, N_WG))
    for tap in range(9):
        shift = ((2 * wg + tap // 3) * HW + tap % 3) * 16
        for s in range(4):
            a = gather(w_mem, (tap * 8 + 2 * s) * 1024, 1024, 128, C, False)
            b = gather(halo, shift + 2 * s * HALO_LD * 16, HALO_LD * 16, 128, N_WG, False)
            wgmma(d, a, b)
    return d


def run_core(src, a_mat):
    """Every tile of the map through the core; the epilogue keeps columns
    n % 64 < 62 inside the map.  Returns the [64, H, W] result."""
    _, H, W = src.shape
    w_mem = stage_weights(a_mat)
    out = np.full((C, H, W), np.nan)
    for r0, c0 in tile_origins(H, W):
        halo = stage_halo(src, r0, c0)
        for wg in range(2):
            d = core_conv(w_mem, halo, wg)
            for n in range(N_WG):
                r, col = r0 + 2 * wg + n // HW, c0 + n % HW
                if n % HW < TW and r < H and col < W:
                    assert np.isnan(out[0, r, col])  # each pixel once
                    out[:, r, col] = d[:, n]
    assert not np.isnan(out).any()
    return out


MAPS = [(20, 36), (34, 66), (8, 130)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape)


@pytest.mark.parametrize("H,W", MAPS)
def test_core_forward_equals_conv2d(H, W):
    """stage2<0> and B2's conv1_2: A = w2 as [co][tap*64 + ci]."""
    x, w2 = _rand((C, H, W), 0), _rand((C, C, 3, 3), 1) * 0.1
    a_mat = torch.from_numpy(w2).permute(0, 2, 3, 1).reshape(C, 9 * C).numpy()
    got = run_core(x, a_mat)
    ref = F.conv2d(torch.from_numpy(x)[None], torch.from_numpy(w2), padding=1)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("H,W", MAPS[:2])
def test_core_data_gradient_equals_conv2d_input(H, W):
    """stage2<1>: A = the flipped transpose [ci][dr'][dc'][co] of w2, as
    ops/stem_train.py builds it."""
    dy, w2 = _rand((C, H, W), 2), _rand((C, C, 3, 3), 3) * 0.1
    w2t = torch.from_numpy(w2).flip(2, 3).permute(1, 2, 3, 0).reshape(C, 9 * C).numpy()
    got = run_core(dy, w2t)
    ref = torch.nn.grad.conv2d_input((1, C, H, W), torch.from_numpy(w2),
                                     torch.from_numpy(dy)[None], padding=1)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


def stage_dy(dy, r0, c0):
    """dw2's dy2 tile: chunk c of output pixel p = r * 64 + col at
    (c * kDyLd + p) * 16 bytes, zero in the thrown-away columns and outside."""
    _, H, W = dy.shape
    mem = np.zeros(8 * DY_LD * 8)
    for p in range(TR * HW):
        r, col = r0 + p // HW, c0 + p % HW
        if p % HW < TW and r < H and col < W:
            for c in range(8):
                mem[(c * DY_LD + p) * 8 + np.arange(8)] = dy[c * 8:c * 8 + 8, r, col]
    return mem


@pytest.mark.parametrize("H,W", MAPS[:2])
def test_dw2_equals_conv2d_weight(H, W):
    """dw2: warpgroup dr, taps (dr, 0..2) as m64n64 (M = ci, N = co), K =
    output pixels, both operands MN-major; partial rows [tap][ci][co]."""
    y1n, dy = _rand((C, H, W), 4), _rand((C, H, W), 5)
    acc = np.zeros((9, C, C))
    for r0, c0 in tile_origins(H, W):
        halo, dys = stage_halo(y1n, r0, c0), stage_dy(dy, r0, c0)
        for dr in range(3):
            for s in range(TR * HW // 16):
                b = gather(dys, s * 16 * 16, 128, DY_LD * 16, C, True)
                for dc in range(3):
                    a = gather(halo, (16 * s + dr * HW + dc) * 16, 128, HALO_LD * 16, C, True)
                    wgmma(acc[dr * 3 + dc], a, b)
    got = torch.from_numpy(acc).view(3, 3, C, C).permute(3, 2, 0, 1).numpy()  # as the wrapper
    ref = torch.nn.grad.conv2d_weight(torch.from_numpy(y1n)[None], (C, C, 3, 3),
                                      torch.from_numpy(dy)[None], padding=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def stage_window(x, rows, xr0, c0):
    """load_x<rows> of stem_sm90.cuh: input rows xr0 .., columns c0 - 2 ..
    c0 + 63 of ``x`` [H, W, 3], zero outside the map."""
    H, W, _ = x.shape
    xs = np.zeros((rows, HW + 2, 3))
    for xr in range(rows):
        for xc in range(HW + 2):
            gr, gc = xr0 + xr, c0 - 2 + xc
            if 0 <= gr < H and 0 <= gc < W:
                xs[xr, xc] = x[gr, gc]
    return xs


def im2col(xs, rows):
    """build_im2col<rows>: chunk k // 8 of pixel p = hr * 64 + hc at
    (chunk * rows * 64 + p) * 16 bytes, K = (dr*3 + dc)*3 + ci, 27..31 zero."""
    ld = rows * HW
    im = np.zeros(4 * ld * 8)
    for p in range(ld):
        hr, hc = p // HW, p % HW
        for k in range(27):
            dr, dc, ci = k // 9, (k // 3) % 3, k % 3
            im[((k // 8) * ld + p) * 8 + k % 8] = xs[hr + dr, hc + dc, ci]
    return im


def conv1_window(x, kernel, r0, c0):
    """The window and im2col of tile (r0, c0), and the image row of im2col row 0."""
    rows = CONV1[kernel]["rows"]
    y0 = r0 - 1 if kernel == "b2" else r0
    return im2col(stage_window(x, rows + 2, y0 - 1, c0), rows), y0


def own_pixel(c0, hc, W):
    """conv1_stats and dw1: slot hc of an im2col row is one of the tile's pixels."""
    return 1 <= hc <= TW and c0 - 1 + hc < W


CONV1_CASES = [pytest.param("b2", 20, 36, id="20-36"), pytest.param("b2", 12, 70, id="12-70"),
               pytest.param("b3", 20, 36, id="b3-20-36"), pytest.param("b3", 12, 70, id="b3-12-70")]


@pytest.mark.parametrize("kernel,H,W", CONV1_CASES)
def test_conv1_1_im2col_equals_conv2d(kernel, H, W):
    """conv1_1 on the tensor cores: the input window staged as load_x does,
    the im2col (K = (dr*3 + dc)*3 + ci, 27..31 zero) in chunk-major pixels,
    pixels as M (m64n64k16, K-major A and B), w1 as ops.stem.w1_operand
    builds it.  B2's epilogue writes the y1 halo pixel p = hr * 64 + hc,
    zero outside the map; B3's conv1_stats keeps the tile's own pixels."""
    x = _rand((H, W, 3), 6)
    w1 = torch.from_numpy(_rand((C, 3, 3, 3), 7)).to(torch.bfloat16).double()
    w1p = stem_ops.w1_operand(w1).double().numpy()
    assert w1p.shape == (C, 32) and not w1p[:, 27:].any()
    w1_mem = stage_weights(w1p)
    ref = F.conv2d(torch.from_numpy(x).permute(2, 0, 1)[None], w1, padding=1)[0].numpy()
    geo = CONV1[kernel]
    ld = geo["rows"] * HW
    for r0, c0 in tile_origins(H, W):
        im, y0 = conv1_window(x, kernel, r0, c0)
        for wg in range(geo["wgs"]):
            for i in range(geo["tiles"]):
                m0 = geo["tiles"] * wg + i
                d = np.zeros((64, C))
                for s in range(2):
                    a = gather(im, (2 * s * ld + 64 * m0) * 16, ld * 16, 128, 64, False)
                    b = gather(w1_mem, 2 * s * 1024, 1024, 128, C, False)
                    wgmma(d, a, b)
                for m in range(64):
                    p = 64 * m0 + m
                    gr, gc = y0 + p // HW, c0 - 1 + p % HW
                    if kernel == "b3" and not own_pixel(c0, p % HW, W):
                        continue
                    if 0 <= gr < H and 0 <= gc < W:
                        np.testing.assert_allclose(d[m], ref[:, gr, gc], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("W", [300, 36, 70])
def test_conv1_stats_tile_walk_covers_every_pixel_once(W):
    """conv1_stats and dw1 keep slots hc = 1 .. 62 inside the map of each
    tile row: over the core's tiles every pixel once (300 % TR == 0)."""
    H = 300
    count = np.zeros((H, W), np.int64)
    for r0, c0 in tile_origins(H, W):
        for hr in range(TR):
            for hc in range(HW):
                if own_pixel(c0, hc, W):
                    count[r0 + hr, c0 - 1 + hc] += 1
    assert (count == 1).all()
    assert "return hc >= 1 && hc <= stem90::TW && T.c0 - 1 + hc < kW;" in TRAIN


@pytest.mark.parametrize("W", [300, 70])
def test_dw1_bulk_rows_land_on_the_own_slots(W):
    """dw1's fetch: per tile row hr, one bulk copy of min(TW, W - c0) pixels
    of 128 bytes from column c0 lands on slots 1 .. of [slot][64 channels]
    at (hr * 64 + 1) * 128: exactly the own slots, which the dy1 pass reads
    at slot * 128; the mbarrier expects the bytes of both maps' 4 rows."""
    for r0, c0 in tile_origins(300, W):
        n = min(TW, W - c0)
        assert n * C * 2 % 16 == 0
        landed = set()
        for hr in range(TR):
            dst = (hr * HW + 1) * C * 2
            assert dst % 16 == 0
            landed |= {dst // (C * 2) + i for i in range(n)}  # slot 1 + i: column c0 + i
        own = {hr * HW + hc for hr in range(TR) for hc in range(HW) if own_pixel(c0, hc, W)}
        assert landed == own
    for line in ("const uint32_t bytes = min(stem90::TW, kW - T.c0) * kC * 2;",
                 "sm90::mbar_expect_tx(bar, 2 * stem90::TR * bytes);",
                 "sm90::bulk_load(buf + (hr * stem90::HW + 1) * kC * 2, dt1 + off, bytes, bar);",
                 "sm90::bulk_load(buf + kF_OffY + (hr * stem90::HW + 1) * kC * 2, y1 + off, bytes, bar);",
                 "const size_t off = pix_off(T.b, T.r0 + hr, T.c0);",
                 "unpack8(*reinterpret_cast<const int4*>(cur + pix * kC * 2 + c * 16), dt);"):
        assert line in TRAIN, line


def stage_dy1(dy, r0, c0):
    """dw1's dy1 tile: chunk c of slot p = hr * 64 + hc (column c0 - 1 + hc) at
    (c * kDyLd + p) * 16 bytes, zero on the slots that are not the tile's."""
    _, H, W = dy.shape
    mem = np.zeros(8 * DY_LD * 8)
    for p in range(TR * HW):
        r, hc = r0 + p // HW, p % HW
        if own_pixel(c0, hc, W):
            for c in range(8):
                mem[(c * DY_LD + p) * 8 + np.arange(8)] = dy[c * 8:c * 8 + 8, r, c0 - 1 + hc]
    return mem


@pytest.mark.parametrize("H,W", [(20, 36), (12, 70)])
def test_dw1_equals_conv2d_weight(H, W):
    """dw1: m64n32k16 with A = dy1 MN-major (M = co), B = conv1_1's im2col
    MN-major (N = 32 patch values), K = the tile's 256 slots, warpgroup wg
    taking k-steps 4wg .. 4wg + 3 (tile row wg); the four warpgroups' sums,
    added in order, make the partial row [k][co], which the wrapper views
    as [3][3][3][64] and permutes to OIHW."""
    x, dy = _rand((H, W, 3), 8), _rand((C, H, W), 9)
    ld = TR * HW
    acc = np.zeros((4, C, 32))
    for r0, c0 in tile_origins(H, W):
        im, _ = conv1_window(x, "b3", r0, c0)
        dys = stage_dy1(dy, r0, c0)
        for wg in range(4):
            for s in range(4 * wg, 4 * wg + 4):
                a = gather(dys, s * 16 * 16, 128, DY_LD * 16, C, True)
                b = gather(im, s * 16 * 16, 128, ld * 16, 32, True)
                wgmma(acc[wg], a, b)
    row = (((acc[0] + acc[1]) + acc[2]) + acc[3]).T  # [32][co]
    assert not row[27:].any()
    got = torch.from_numpy(row[:27].copy()).view(3, 3, 3, C).permute(3, 2, 0, 1).numpy()
    ref = torch.nn.grad.conv2d_weight(torch.from_numpy(x).permute(2, 0, 1)[None], (C, 3, 3, 3),
                                      torch.from_numpy(dy)[None], padding=1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ fragments


def frag(t, idx):
    """(row, column) of accumulator register idx of thread t in the
    warpgroup, for wgmma m64nNk16 with f32 accumulators."""
    j, e = idx // 4, idx % 4
    return 16 * (t // 32) + (t % 32) // 4 + 8 * (e >> 1), 8 * j + 2 * (t % 4) + (e & 1)


def test_pool_fragment_is_one_thread():
    """stem.cu pools register 4j (+1, +32, +33) into pooled column 4j + q of
    channel row(4j), and 4j+2 (+3, +34, +35) for channel + 8: the 2x2
    window's four pixels, rows 0 and 1 of the two-row accumulator."""
    for t in range(128):
        q = t % 4
        for j in range(8):
            for base, dco in ((4 * j, 0), (4 * j + 2, 8)):
                cells = [frag(t, base + o) for o in (0, 1, 32, 33)]
                co = 16 * (t // 32) + (t % 32) // 4 + dco
                assert {r for r, _ in cells} == {co}
                pixels = {(n // HW, n % HW) for _, n in cells}
                pc = 4 * j + q
                assert pixels == {(0, 2 * pc), (0, 2 * pc + 1), (1, 2 * pc), (1, 2 * pc + 1)}


def test_stage2_epilogue_fragment_covers_each_output_once():
    """stage2's epilogue reads acc[4j + 2h + e] as channel 16 * warp + lane/4
    + 8h at column 8j + 2q + e: every (channel, column) once."""
    seen = set()
    for t in range(128):
        for j in range(16):
            for h in range(2):
                for e in range(2):
                    idx = 4 * j + 2 * h + e
                    co = 16 * (t // 32) + (t % 32) // 4 + 8 * h
                    n = 8 * j + 2 * (t % 4) + e
                    assert frag(t, idx) == (co, n)
                    seen.add((co, n))
    assert len(seen) == C * N_WG


def test_dw1_fragment_writes_each_partial_entry_once():
    """dw1 reads acc[i] of the m64n32 accumulator as co = 16 * warp + lane/4
    + 8 * ((i >> 1) & 1), k = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)."""
    seen = set()
    for t in range(128):
        for i in range(16):
            co = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i >> 1) & 1)
            k = 8 * (i >> 2) + 2 * (t % 4) + (i & 1)
            assert frag(t, i) == (co, k)
            seen.add((co, k))
    assert seen == {(co, k) for co in range(C) for k in range(32)}
    assert "const int co0 = 16 * warp + (lane >> 2), k0 = 2 * (lane & 3);" in TRAIN
    assert "const int co = co0 + 8 * ((i >> 1) & 1), k = k0 + 8 * (i >> 2) + (i & 1);" in TRAIN
    assert "prow[k * kC + co] = ((acc[i] + r[0]) + r[32 * kC]) + r[2 * 32 * kC];" in TRAIN


def test_conv1_stats_sums_cover_each_channel_once():
    """conv1_stats: thread lane holds sums s[2j + e] of channel 8j + 2q + e
    (q = lane % 4); the xor shuffles over offsets 4, 8, 16 leave in every
    lane the sum over the 8 lanes of its q, and lanes 0..3 write the warp's
    64 channels, each once, into red."""
    vals = np.random.default_rng(10).normal(size=(32, 16))
    s = vals.copy()
    for o in (4, 8, 16):
        s = s + s[np.arange(32) ^ o]
    red = np.full(C, np.nan)
    for lane in range(4):
        q = lane % 4
        for j in range(8):
            for e in range(2):
                assert np.isnan(red[8 * j + 2 * q + e])
                red[8 * j + 2 * q + e] = s[lane, 2 * j + e]
    want = np.zeros(C)
    for lane in range(32):
        for j in range(8):
            for e in range(2):
                want[8 * j + 2 * (lane % 4) + e] += vals[lane, 2 * j + e]
    np.testing.assert_allclose(red, want, rtol=1e-12)
    assert "for (int o = 4; o < 32; o <<= 1)" in TRAIN
    assert "r[8 * j + 2 * q + e] = s[2 * j + e];" in TRAIN


def stmatrix_targets(addr, trans):
    """Where stmatrix .x4 (or ldmatrix .x4, the same map) puts each
    register element: {(lane, m, e): byte address}.  Lane L gives the
    address of row L % 8 of tile L / 8 (``addr(L // 8, L % 8)``); register
    m of lane t holds row t // 4, columns 2 * (t % 4) + e of tile m; with
    .trans a tile's column k is stored as its row k."""
    out = {}
    for t in range(32):
        for m in range(4):
            for e in range(2):
                i, k = t // 4, 2 * (t % 4) + e
                out[t, m, e] = addr(m, k) + 2 * i if trans else addr(m, i) + 2 * k
    return out


def test_stage2_epilogue_stmatrix_lands_on_pixel_rows():
    """stage2's staging tile is [pixel n][channel] with rows STAGE_LD bytes:
    register m of the x4 at j0 is acc[4j + 2h + e], j = j0 + m / 2, h = m % 2."""
    stage_ld = int(_const("STAGE_LD"))
    for warp in range(4):
        for j0 in range(0, 16, 2):
            addr = lambda m, r: (8 * (j0 + m // 2) + r) * stage_ld + (16 * warp + 8 * (m % 2)) * 2
            for (t, m, e), a in stmatrix_targets(addr, trans=True).items():
                j, h = j0 + m // 2, m % 2
                co, n = frag(32 * warp + t, 4 * j + 2 * h + e)
                assert a == n * stage_ld + co * 2


def test_conv1_1_epilogue_stmatrix_lands_on_the_halo_layout():
    """stem.cu's conv1_1 epilogue: register m of the x4 at (i, h, j0) is the
    pair (a1[i][4j + 2h], + 1), j = j0 + m, for pixel p0 + lane / 4; it must
    land at chunk j of that pixel, channel 8j + 2q + e."""
    for wg in range(2):
        for warp in range(4):
            for i in range(3):
                for h in range(2):
                    p0 = 64 * (3 * wg + i) + 16 * warp + 8 * h
                    for j0 in (0, 4):
                        addr = lambda m, r: ((j0 + m) * HALO_LD + p0 + r) * 16
                        for (t, m, e), a in stmatrix_targets(addr, trans=False).items():
                            j, p, co = j0 + m, p0 + t // 4, 8 * (j0 + m) + 2 * (t % 4) + e
                            assert frag(32 * warp + t, 4 * j + 2 * h + e) == (16 * warp + 8 * h + t // 4, co)
                            assert a == (j * HALO_LD + p) * 16 + (co % 8) * 2


def test_conv1_stats_stmatrix_lands_on_pixel_rows():
    """conv1_stats' staging row is [slot][channel] with rows STAGE_LD bytes:
    register m of the x4 at (h, j0) is the pair (a1[0][4j + 2h], + 1),
    j = j0 + m, for slot 16 * warp + 8h + lane / 4."""
    stage_ld = int(_const("STAGE_LD"))
    for warp in range(4):
        for h in range(2):
            p0 = 16 * warp + 8 * h
            for j0 in (0, 4):
                addr = lambda m, r: (p0 + r) * stage_ld + (j0 + m) * 16
                for (t, m, e), a in stmatrix_targets(addr, trans=False).items():
                    j = j0 + m
                    slot, co = frag(32 * warp + t, 4 * j + 2 * h + e)
                    assert slot == p0 + t // 4 and co == 8 * j + 2 * (t % 4) + e
                    assert a == slot * stage_ld + co * 2
    assert ("stem90::stmatrix_x4(stage + (p0 + (lane & 7)) * stem90::STAGE_LD + "
            "(j0 + (lane >> 3)) * 16,") in TRAIN


# ------------------------------------------------------------ the work split


@pytest.mark.parametrize("sms", [114, 132])  # H100 PCIe, H100 SXM
@pytest.mark.parametrize("B", [1, 3, 5, 8, 16, 32])
def test_work_split_covers_every_pooled_pixel_once(B, sms):
    """Blocks walk tiles blk, blk + grid, ...; each tile writes pooled rows
    r0/2 + wg and 31 pooled columns from c0/2 (clipped at 150)."""
    grid = stem_ops.grid_size(B, sms)
    assert grid == min(B * stem_ops.TILES_PER_IMAGE, sms)
    count = np.zeros((B, 150, 150), np.int64)
    taken = np.zeros(B * stem_ops.TILES_PER_IMAGE, np.int64)
    for blk in range(grid):
        for t in range(blk, B * stem_ops.TILES_PER_IMAGE, grid):
            taken[t] += 1
            b, r0, c0 = stem_ops.tile_origin(t)
            for wg in range(2):
                for pc in range(TW // 2):
                    if c0 // 2 + pc < 150:
                        count[b, r0 // 2 + wg, c0 // 2 + pc] += 1
    assert (taken == 1).all()
    assert (count == 1).all()


def test_python_geometry_matches_the_core():
    assert (stem_ops.TILE_ROWS, stem_ops.TILE_COLS) == (TR, TW) and HW == TW + 2
    assert _const("TILES_Y") == "H / TR" and _const("TILES_X") == "(W + TW - 1) / TW"
    assert stem_ops.TILES_PER_IMAGE == (300 // TR) * -(-300 // TW) == 375
    assert stem_ops.tile_origin(0) == (0, 0, 0)
    assert stem_ops.tile_origin(stem_ops.TILES_PER_IMAGE + 6) == (1, TR, TW)
    # the last tap of warpgroup 1 reads within a chunk's pixels
    assert (2 + 2) * HW + 2 + N_WG - 1 < HALO_LD and HALO_LD % 2 == 1 and DY_LD % 2 == 1


# ------------------------------------------------------------ the sources


@pytest.mark.parametrize("name", ["stem.cu", "stem_train.cu"])
def test_sources_use_wgmma_not_wmma(name):
    text = (CSRC / name).read_text()
    for old in ("wmma::", "mma.sync", "mma_sync", "<mma.h>", "load_matrix_sync"):
        assert old not in text, (name, old)
    assert '#include "stem_sm90.cuh"' in text
    assert "wgmma.mma_async" in CORE


def _section(text, start, end):
    return text[text.index(start):text.index(end)]


def test_stem_train_contractions_on_the_core():
    """Every contraction of B3 issues wgmma: stage2's taps, dw2, and the two
    K = 27 launches, conv1_stats (conv1_1<2>, the core's m64n64k16 from the
    shared im2col) and dw1 (m64n32k16); no scalar FMA loop is left."""
    text = TRAIN
    stage2 = _section(text, "stage2_kernel(", "// ------------------------------------------------------------ forward C")
    dw2 = _section(text, "// ---------------------------------------------------------- backward dW2",
                   "// ---------------------------------------------------------- backward dW1")
    conv1 = _section(text, "// ------------------------------------------------------------ forward A",
                     "// ------------------------------------------- forward B / backward E (stage 2)")
    dw1 = _section(text, "// ---------------------------------------------------------- backward dW1",
                   "// ------------------------------------------------- fixed-order column sums")
    for taps in ("<0, 3>", "<3, 6>", "<6, 9>"):
        assert f"stem90::conv_taps{taps}" in stage2
    assert "stem90::wgmma_64<1, 1>" in dw2
    assert "stem90::conv1_1<1>(a1, ima + (it & 1) * kImBytes, w1a, kImPix, wg);" in conv1
    assert "stem90::wgmma_32<1, 1>(acc, da, db)" in dw1
    for body in (conv1, dw1):
        assert "conv1_im2col(" in body
    assert "stem90::build_im2col<stem90::TR, kImPix, 0, 2>(xs, im, tid)" in conv1
    conv1_1 = _section(CORE, "__device__ __forceinline__ void conv1_1(", "}  // namespace stem90")
    assert "wgmma_64<0, 0>(a[i], da, db)" in conv1_1
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in CORE
    for body in (conv1, dw1):
        assert "fmaf(" not in body
    # B2 builds conv1_1 from the same helpers
    b2 = (CSRC / "stem.cu").read_text()
    assert "conv1_1<3>(a1, ima, w1a, kImLd, 3 * wg)" in b2
    assert "stem90::build_im2col<HR, kThreads, C0, C1>(xcur, im, threadIdx.x)" in b2
    assert "stem90::load_x<kXRows, kThreads>" in b2


def _exports(name):
    text = (CSRC / name).read_text()
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}


def test_exported_symbols_match_the_bindings():
    """The C entries and their argument counts are what ops/stem.py and
    ops/stem_train.py hand ctypes (argtypes are set when the library is
    loaded, so they are read from the wrappers' sources)."""
    ops = Path(stem_ops.__file__).parent
    assert _exports("stem.cu") == {"ssdx_stem_forward": 9}
    assert "[ctypes.c_void_p] * 6 + [ctypes.c_int] * 2" in (ops / "stem.py").read_text()
    st = (ops / "stem_train.py").read_text()
    sigs = dict(re.findall(r'"(ssdx_st_\w+)": \[([^\]]*)\]', st))
    assert set(sigs) == set(_exports("stem_train.cu"))
    for name, n in _exports("stem_train.cu").items():
        assert len(sigs[name].split(",")) == n, name
    # conv1_stats takes B2's bf16 w1 [64][32]
    assert "ssdx_st_conv1(const void* x, const void* w1, const float* b1" in TRAIN
    assert "w1p = w1_operand(w1.detach())" in st


def test_b3_cut_variants_apply_to_the_source():
    """tools/profile_stem.py --b3-cuts cuts conv1_stats and dw1 at text the
    source still has: each variant differs from the whole and keeps every
    exported entry."""
    from ssdx_torch.tools import profile_stem

    variants = profile_stem.b3_cut_variants(TRAIN)
    assert variants["whole"] == TRAIN
    for name, text in variants.items():
        if name != "whole":
            assert text != TRAIN and len(text) <= len(TRAIN) + 16, name
        assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(_exports("stem_train.cu")), name
    body = _section(variants["dw1 without fetch"], "dw1_kernel(const",
                    "// ------------------------------------------------- fixed-order column sums")
    assert "mbar_wait" not in body and "dw1_fetch(" not in body
