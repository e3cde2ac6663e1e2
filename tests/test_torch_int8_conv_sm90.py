"""What of the int8 conv kernel (``ssdx_torch/csrc/int8_conv.cu``, B4a and
B4b on the TMA + wgmma main loop of ``csrc/sm90.cuh``) can be checked
without a card.

* The loader's addresses: ``int8_conv.a_load`` makes the tables and corner
  bounds that the wrapper hands the kernel.  Filling A from them as each
  loader does (the copies loader's arithmetic on the tables; the im2col
  TMA copy's walk of the map's box from a table corner; the tiled loader's
  plain matrix) and contracting block by block in int64 against the
  weights as the kernel lays them out (``[cout][kh][kw][cin]``) reproduces
  ``quant.conv_int_exact`` exactly, on every topology layer at width 0.25
  and on the geometries that are easy to get wrong: stride 2, dilation 6,
  pad 0, Cin = 64 and a ragged M.  Where both loaders can take a layer,
  the im2col tables fill A as the copies tables do.
* The launch plan (``int8_conv.plan``): loader, k-block, tile, blocks an SM
  and waves of every full-width layer at bs=32, K covered exactly, and the
  rules behind them.
* The source: TMA, im2col and wgmma, no mma.sync or ldmatrix path, and the
  entry points, arguments and tiles that the binding and the plan use.
* The wrapper's refusals, and the build rule that a header's bytes are part
  of every library's name.
The kernel itself runs on the card: ``python -m
ssdx_torch.tools.check_int8_conv`` and ``chip_smoke.py`` phases 11-13.
"""
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from ssdx_torch import quant
from ssdx_torch.ops import _build
from ssdx_torch.ops import int8_conv as ic
from ssdx_torch.tools import check_int8_conv as chk

CSRC = Path(__file__).resolve().parents[1] / "ssdx_torch" / "csrc"
SMS = 132

# (name, B, H, cin, cout, k, stride, dilation, pad): the geometries of the
# network that index arithmetic gets wrong first, at small sizes
GEOMETRIES = [
    ("dilation6", 2, 19, 128, 16, 3, 1, 6, 6),
    ("stride2", 2, 19, 64, 16, 3, 2, 1, 1),
    ("stride2_odd", 3, 10, 128, 32, 3, 2, 1, 1),
    ("pad0", 2, 5, 128, 32, 3, 1, 1, 0),
    ("pad0_to_1x1", 4, 3, 128, 16, 3, 1, 1, 0),
    ("cin64", 2, 12, 64, 16, 3, 1, 1, 1),
    ("ragged_m", 3, 7, 32, 16, 3, 1, 1, 1),
    ("one_by_one", 3, 7, 48, 16, 1, 1, 1, 0),
]


def _layer_data(seed, B, H, cin, cout, k):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(-127, 128, (B, H, H, cin)).astype(np.int8))
    w = torch.as_tensor(rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
    return x, w


def _copies_offsets(p, load):
    """``[rows, chunks]`` byte offsets into x that the copies loader reads
    (-1: zero fill), by the kernel's arithmetic on ``a_load``'s tables:
    row (n * H * W, top, left), chunk (dy, dx, channel, in K)."""
    r = load.rows.to(torch.int64)[:, None, :]
    q = load.kblocks.to(torch.int64)[None, :, :]
    iy, ix = r[..., 1] + q[..., 0], r[..., 2] + q[..., 1]
    ok = (q[..., 3] != 0) & (iy >= 0) & (iy < p.H) & (ix >= 0) & (ix < p.W)
    off = (r[..., 0] + iy * p.W + ix) * p.cin + q[..., 2]
    return torch.where(ok, off, torch.full_like(off, -1))


def _copies_a(x, p, load):
    """A ``[rows, nk * 128]`` as the copies fill it: 16 bytes from each
    offset, zeros where it is -1."""
    off = _copies_offsets(p, load)
    flat = torch.cat([x.reshape(-1).to(torch.int64), torch.zeros(16, dtype=torch.int64)])
    idx = torch.where(off[..., None] >= 0, off[..., None] + torch.arange(16),
                      torch.full((1, 1, 16), flat.numel() - 1))
    return flat[idx].reshape(off.shape[0], -1)


def _im2col_a(x, p, load):
    """A ``[tiles * bm, nk * kb]`` as the im2col TMA copies fill it: for
    tile t and k-block kb, the map's box walks ``bm`` window corners from
    ``load.rows[t]`` (along W, then H, then N, at ``stride`` steps, each
    corner within [lower, size - 1 + upper]), moves each by the k-block's
    offsets and reads ``kb`` channels from its channel, zeros outside x."""
    B, H, W, _ = x.shape
    lo, st = load.lower, p.stride
    walk_w, walk_h = ((n - 1 + load.upper - lo) // st + 1 for n in (W, H))
    cw, ch, cn = load.rows.to(torch.int64)[:, :3].T
    assert ((cw - lo) % st == 0).all() and ((ch - lo) % st == 0).all()  # corners on the walk
    start = (cn * walk_h + (ch - lo) // st) * walk_w + (cw - lo) // st
    i = (start[:, None] + torch.arange(p.bm)).reshape(-1)
    n, hy, wx = i // (walk_h * walk_w), i // walk_w % walk_h, i % walk_w
    a = torch.zeros(len(i), p.nk * p.kb, dtype=torch.int64)
    for kb, (c, ow, oh, _) in enumerate(load.kblocks.tolist()):
        iy, ix = lo + hy * st + oh, lo + wx * st + ow
        ok = (n < B) & (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        a[ok, kb * p.kb:(kb + 1) * p.kb] = x[n[ok], iy[ok], ix[ok], c:c + p.kb].to(torch.int64)
    return a


def _tiled_a(x, p):
    """A as the tiled loader's TMA copies fill it: x as ``[M, cin]``, zeros
    past M and past cin."""
    a = torch.zeros(-(-p.M // p.bm) * p.bm, p.nk * p.kb, dtype=torch.int64)
    a[:p.M, :p.cin] = x.reshape(p.M, p.cin).to(torch.int64)
    return a


def _a_matrix(x, p):
    load = ic.a_load(p)
    if p.loader == "tiled":
        return _tiled_a(x, p)
    return _im2col_a(x, p, load) if p.loader == "im2col" else _copies_a(x, p, load)


def _contract_blocks(x, w, p):
    """sum over the plan's k-blocks of A_block . W_block^T, in int64, for
    the M rows of the output."""
    wk = w.permute(0, 2, 3, 1).reshape(p.cout, -1).to(torch.int64)  # [cout][kh][kw][cin]
    wk = torch.nn.functional.pad(wk, (0, p.nk * p.kb - p.K))
    a = _a_matrix(x, p)
    assert a.shape == (-(-p.M // p.bm) * p.bm, p.nk * p.kb)
    acc = torch.zeros(a.shape[0], p.cout, dtype=torch.int64)
    for kb in range(p.nk):
        acc += a[:, kb * p.kb:(kb + 1) * p.kb] @ wk[:, kb * p.kb:(kb + 1) * p.kb].T
    return acc[:p.M]


def _exact(x, w, k, stride, dilation, pad):
    spec = quant._L("layer", k, stride, pad, dilation, None, None)
    return quant.conv_int_exact(x, w, spec).reshape(-1, w.shape[0]).to(torch.int64)


@pytest.mark.parametrize("layer", chk.layers(0.25), ids=lambda l: l.name)
def test_a_source_contracts_to_the_exact_conv_on_every_layer(layer):
    x, w = _layer_data(int(layer.name.rsplit("_", 1)[1]), 1, layer.H, layer.cin, layer.cout,
                       layer.k)
    p = ic.plan(x.shape, layer.cout, layer.k, layer.stride, layer.dilation, layer.pad, SMS)
    got = _contract_blocks(x, w, p)
    assert torch.equal(got, _exact(x, w, layer.k, layer.stride, layer.dilation, layer.pad))


@pytest.mark.parametrize("name,B,H,cin,cout,k,stride,dilation,pad", GEOMETRIES)
def test_a_source_contracts_to_the_exact_conv_on_hard_geometries(name, B, H, cin, cout, k,
                                                                  stride, dilation, pad):
    x, w = _layer_data(len(name), B, H, cin, cout, k)
    p = ic.plan(x.shape, cout, k, stride, dilation, pad, SMS)
    if name == "ragged_m":
        assert p.M % p.bm and p.M == 147
    exact = _exact(x, w, k, stride, dilation, pad)
    assert torch.equal(_contract_blocks(x, w, p), exact)
    assert exact.abs().max() > 0
    if k == 3:  # the other 3x3 loader, where it can take the layer, too
        other = "copies" if p.loader == "im2col" else "im2col"
        q = _forced(p, other)
        if q is not None:
            assert torch.equal(_contract_blocks(x, w, q), exact), other


def _forced(p, loader):
    """The plan with the other 3x3 loader (the k-block it needs, 128-row
    tiles), or None where that loader cannot take the layer."""
    if loader == "im2col":
        if p.cin % 64:
            return None
        kb = 64 if p.cin % ic.BK else ic.BK
    else:
        kb = ic.BK
    return p._replace(loader=loader, kb=kb, bm=128, nk=-(-p.K // kb))


def test_a_source_zero_fills_padding_rows_past_m_and_k_past_k():
    p = ic.plan((2, 5, 5, 32), 16, 3, 1, 1, 1, SMS)  # K = 288: the third k-block is ragged
    assert p.loader == "copies"
    load = ic.a_load(p)
    off = _copies_offsets(p, load)
    assert off.shape == (-(-p.M // p.bm) * p.bm, p.nk * ic.BK // 16)
    assert (off[p.M:] == -1).all()  # rows past M
    assert (off[:, p.K // 16:] == -1).all()  # k past K
    assert (load.kblocks[p.K // 16:, 3] == 0).all() and (load.kblocks[:p.K // 16, 3] == 1).all()
    assert (off[0, :2] == -1).all()  # pixel 0's first tap (-1, -1) is padding
    assert off[0, 8] == 0  # its centre tap (k = 4 * 32) is x[0, 0, 0, 0]


@pytest.mark.parametrize("name,B,H,cin,cout,k,stride,dilation,pad",
                         [g for g in GEOMETRIES if g[3] % 64 == 0 and g[5] == 3])
def test_im2col_copies_read_what_a_source_names(name, B, H, cin, cout, k, stride, dilation,
                                                pad):
    """Both loaders' tables of one layer fill A alike, row for row."""
    x, _ = _layer_data(len(name), B, H, cin, cout, k)
    p = ic.plan(x.shape, cout, k, stride, dilation, pad, SMS)
    im, cp = _forced(p, "im2col"), _forced(p, "copies")
    assert im.K % im.kb == 0  # an im2col k-block is one tap's channels
    a_im = _im2col_a(x, im, ic.a_load(im))[:, :p.K]
    a_cp = _copies_a(x, cp, ic.a_load(cp))[:, :p.K]
    assert a_im.shape == a_cp.shape and torch.equal(a_im, a_cp), name


def test_im2col_coords_of_a_tile_and_tap():
    p = ic.plan((32, 19, 19, 512), 1024, 3, 1, 6, 6, SMS)  # ConvBNRelu_13
    assert p.loader == "im2col" and p.kb == 128 and p.bm == 128
    load = ic.a_load(p)
    assert (load.lower, load.upper) == (-6, 6 - 12)
    assert load.rows.shape == (-(-p.M // p.bm), 4) and load.kblocks.shape == (p.nk, 4)
    # tile 3 starts at pixel 384: image 1, row 1, column 4 (361 + 19 + 4)
    assert load.rows[3].tolist() == [4 - 6, 1 - 6, 1, 0]
    # k-block 29: tap 7 = (ky 2, kx 1), channels 128..255
    assert load.kblocks[29].tolist() == [128, 6, 12, 0]


def test_a_load_gives_the_tiled_loader_no_tables():
    p = ic.plan((2, 5, 5, 64), 32, 1, sms=SMS)
    load = ic.a_load(p)
    assert p.loader == "tiled" and load.rows.numel() == load.kblocks.numel() == 0
    assert (load.lower, load.upper) == (0, 0)


@pytest.mark.parametrize("layer", chk.layers(), ids=lambda l: l.name)
def test_a_load_tables_fit_the_kernel(layer):
    """int32 [n, 4] tables, one row a tile (im2col) or a tile's row (copies)
    and one a k-block (im2col) or 16-byte chunk (copies); corner bounds and
    offsets within the map's limits."""
    for B in (32, 3):
        p = ic.plan((B, layer.H, layer.H, layer.cin), layer.cout, layer.k, layer.stride,
                    layer.dilation, layer.pad, SMS)
        for q in [p] + ([_forced(p, "copies")] if p.loader == "im2col" and B == 3 else []):
            load = ic.a_load(q)
            tiles_m = -(-q.M // q.bm)
            if q.loader == "tiled":
                continue
            assert load.rows.dtype == load.kblocks.dtype == torch.int32
            per_tile = 1 if q.loader == "im2col" else q.bm
            assert load.rows.shape == (tiles_m * per_tile, 4)
            assert load.kblocks.shape == (q.nk * (1 if q.loader == "im2col" else 8), 4)
            if q.loader == "im2col":
                assert -127 <= load.lower <= 0 and -128 <= load.upper <= 127
                assert 0 <= int(load.kblocks[:, 1:3].min()) and int(load.kblocks[:, 1:3].max()) < 256


# ------------------------------------------------------------------ plan

# bs=32, full width: (loader, kb, bm, bn, ctas, nk, tiles) per layer
PLANS = {
    "ConvBNRelu_2": ("im2col", 64, 128, 128, 2, 9, 5625),
    "ConvBNRelu_3": ("im2col", 128, 128, 128, 2, 9, 5625),
    "ConvBNRelu_4": ("im2col", 128, 128, 128, 2, 9, 2814),
    "ConvBNRelu_5": ("im2col", 128, 128, 128, 2, 18, 2814),
    "ConvBNRelu_6": ("im2col", 128, 128, 128, 2, 18, 2814),
    "ConvBNRelu_7": ("im2col", 128, 128, 128, 2, 18, 1444),
    "ConvBNRelu_8": ("im2col", 128, 128, 128, 2, 36, 1444),
    "ConvBNRelu_9": ("im2col", 128, 128, 128, 2, 36, 1444),
    "ConvBNRelu_10": ("im2col", 128, 128, 128, 2, 36, 364),
    "ConvBNRelu_11": ("im2col", 128, 128, 128, 2, 36, 364),
    "ConvBNRelu_12": ("im2col", 128, 128, 128, 2, 36, 364),
    "ConvBNRelu_13": ("im2col", 128, 128, 128, 2, 36, 728),
    "ConvBNRelu_14": ("tiled", 128, 128, 128, 2, 8, 728),
    "ConvBNRelu_15": ("tiled", 128, 128, 128, 2, 8, 182),
    "ConvBNRelu_16": ("im2col", 128, 128, 128, 1, 18, 100),
    "ConvBNRelu_17": ("tiled", 128, 64, 128, 1, 4, 50),
    "ConvBNRelu_18": ("im2col", 128, 64, 128, 1, 9, 26),
    "ConvBNRelu_19": ("tiled", 128, 64, 128, 1, 2, 13),
    "ConvBNRelu_20": ("im2col", 128, 64, 128, 1, 9, 10),
    "ConvBNRelu_21": ("tiled", 128, 64, 128, 1, 2, 5),
    "ConvBNRelu_22": ("im2col", 128, 64, 128, 1, 9, 2),
}


@pytest.mark.parametrize("layer", chk.layers(), ids=lambda l: l.name)
def test_plan_of_every_full_width_layer_at_bs32(layer):
    p = ic.plan((32, layer.H, layer.H, layer.cin), layer.cout, layer.k, layer.stride,
                layer.dilation, layer.pad, SMS)
    assert (p.loader, p.kb, p.bm, p.bn, p.ctas, p.nk, p.tiles) == PLANS[layer.name]
    assert (p.nk - 1) * p.kb < p.K <= p.nk * p.kb  # K covered exactly
    assert p.tiles == -(-p.M // p.bm) * -(-p.cout // p.bn)
    assert p.waves == pytest.approx(p.tiles / (SMS * p.ctas))
    if p.loader == "im2col":
        assert p.cin % p.kb == 0  # a k-block never spans taps
    if p.ctas == 2:
        assert (p.bm, p.bn) == (128, 128) and p.loader != "copies" and p.tiles >= SMS


def test_plan_cin64_takes_64_byte_k_blocks_or_copies():
    p = ic.plan((32, 150, 150, 64), 128, 3, 1, 1, 1, SMS)  # ConvBNRelu_2
    assert (p.loader, p.kb, p.nk, p.K) == ("im2col", 64, 9, 576)
    small = ic.plan((1, 12, 12, 64), 16, 3, 1, 1, 1, SMS)  # under a wave of pairs
    assert (small.loader, small.kb, small.nk) == ("copies", 128, 5)  # the last block half empty


def test_plan_rules():
    # a small input with channels a multiple of 128 takes im2col, whatever its size
    assert ic.plan((1, 8, 8, 128), 128, 3, 1, 1, 1, SMS).loader == "im2col"
    assert ic.plan((32, 3, 3, 128), 256, 3, 1, 1, 0, SMS).loader == "im2col"
    # channels that are no multiple of 64 take the copies
    assert ic.plan((32, 38, 38, 96), 256, 3, 1, 1, 1, SMS).loader == "copies"
    # a corner past the map's limits takes the copies
    assert ic.plan((32, 150, 150, 128), 128, 3, 1, 70, 1, SMS).loader == "copies"
    # 1x1 layers are plain matrices
    assert ic.plan((1, 3, 3, 16), 16, 1, sms=SMS).loader == "tiled"
    # a wave of 128 x 128 tiles takes them two blocks an SM, whatever K;
    # under a wave, or with the copies loader, one block an SM
    tile = lambda p: (p.bm, p.bn, p.ctas)
    assert tile(ic.plan((32, 38, 38, 512), 512, 3, 1, 1, 1, SMS)) == (128, 128, 2)
    assert tile(ic.plan((32, 19, 19, 512), 512, 3, 1, 1, 1, SMS)) == (128, 128, 2)
    assert tile(ic.plan((32, 10, 10, 512), 128, 1, sms=SMS)) == (64, 128, 1)
    assert tile(ic.plan((32, 19, 19, 256), 512, 3, 2, 1, 1, SMS)) == (128, 128, 1)
    assert tile(ic.plan((32, 38, 38, 96), 256, 3, 1, 1, 1, SMS)) == (64, 128, 1)


@pytest.mark.parametrize("B", [32, 3, 1])
def test_every_planned_launch_is_built(B):
    src = _src("int8_conv.cu")
    built = {tuple(map(int, t)) + (ic.BK,) for t in re.findall(
        r"bm == (\d+) && bn == (\d+) && ctas == (\d+)", src)}
    assert "launch<128, 128, 2, 64>" in src  # 64-byte k-blocks: one two-block instance
    assert built | {(128, 128, 2, 64)} == set(ic.BUILT)
    for width in chk.WIDTHS:
        for layer in chk.layers(width):
            p = ic.plan((B, layer.H, layer.H, layer.cin), layer.cout, layer.k, layer.stride,
                        layer.dilation, layer.pad, SMS)
            assert (p.bm, p.bn, p.ctas, p.kb) in ic.BUILT, (layer.name, p)


# ---------------------------------------------------------------- source


def _src(name, comments=False):
    """A source with the csrc headers it includes appended; comments out
    unless asked for."""
    text = (CSRC / name).read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', text):
        text += (CSRC / header).read_text()
    return text if comments else re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("needle", ["wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8",
                                    "cp.async.bulk.tensor.2d", "cp.async.bulk.tensor.4d",
                                    ".im2col.", "cuTensorMapEncodeIm2col",
                                    "mbarrier.try_wait.parity", "setmaxnreg",
                                    "cp.async.mbarrier.arrive.noinc",
                                    "__grid_constant__ const CUtensorMap", "consume<int"])
def test_conv_source_uses_tma_and_wgmma(needle):
    assert needle in _src("int8_conv.cu")


@pytest.mark.parametrize("word", ["mma.sync", "ldmatrix", "igemm_kernel", "m16n8k32"])
def test_conv_source_has_no_mma_sync_path(word):
    assert word not in (CSRC / "int8_conv.cu").read_text()  # comments included


def test_conv_source_exports_what_the_binding_loads():
    src = _src("int8_conv.cu")
    binding = (Path(ic.__file__)).read_text()
    counts = re.search(r"fn\.argtypes = \[p\] \* (\d+) \+ \[i\] \* (\d+) \+ \[p\]", binding)
    n_ptr, n_int = int(counts[1]) + 1, int(counts[2])
    for name in ("ssdx_int8_conv3", "ssdx_int8_mm"):
        assert f"lib.{name}" in binding
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1].split(",")
        assert sum("*" in a for a in params) == n_ptr, name
        assert sum(re.match(r"\s*int \w+$", a) is not None for a in params) == n_int, name
    assert set(ic.LOADERS.items()) == {("copies", 0), ("tiled", 1), ("im2col", 2)}
    assert re.search(r"enum Loader \{ COPIES = 0, TILED = 1, IM2COL = 2 \}", src)


def test_gemm_and_conv_share_one_main_loop():
    for name in ("gemm_sm90.cu", "int8_conv.cu"):
        text = (CSRC / name).read_text()
        assert '#include "sm90.cuh"' in text
        assert "wgmma.mma_async" not in re.sub(r"//[^\n]*", "", text), name  # only in the header
    assert "void consume(" in (CSRC / "sm90.cuh").read_text()


# --------------------------------------------------------------- wrapper

REFUSED = [
    ("dtype", dict(x_dtype=torch.int16), "int8 operands"),
    ("kernel 5x5", dict(k=5), "1x1 or 3x3"),
    ("cin 24", dict(cin=24), "multiples of 16"),
    ("cout 8", dict(cout=8), "multiples of 16"),
    ("1x1 strided", dict(k=1, stride=2, pad=0), "plain matmul"),
    ("tap int8", dict(tap_dtype=torch.int8), "tap_dtype"),
    ("scale shape", dict(scale_len=3), r"must be \[32\]"),
    ("empty output", dict(H=1, pad=0), "empty output"),
    ("no next scale", dict(emit="both", ns=False), "needs next_in_scale"),
    ("rank", dict(rank3=True), r"x \[B,H,W,cin\]"),
]


@pytest.mark.parametrize("name,kw,match", REFUSED, ids=[r[0] for r in REFUSED])
def test_kernel_args_refuse_what_the_kernel_does_not_take(name, kw, match):
    cin, cout, k, H = kw.get("cin", 32), kw.get("cout", 32), kw.get("k", 3), kw.get("H", 6)
    x = torch.zeros(2, H, H, cin, dtype=kw.get("x_dtype", torch.int8))
    if kw.get("rank3"):
        x = x[0]
    w = torch.zeros(cout, cin, k, k, dtype=torch.int8)
    n = kw.get("scale_len", cout)
    ns = torch.ones(n) if kw.get("ns", True) else None
    with pytest.raises(ValueError, match=match):
        ic._check_kernel_args(x, w, torch.ones(n), torch.zeros(n), ns, kw.get("stride", 1), 1,
                              kw.get("pad", 1), kw.get("emit", "int8"),
                              kw.get("tap_dtype", torch.float32))


def test_kernel_args_take_every_full_width_layer():
    for layer in chk.layers():
        x = torch.zeros(2, layer.H, layer.H, layer.cin, dtype=torch.int8)
        w = torch.zeros(layer.cout, layer.cin, layer.k, layer.k, dtype=torch.int8)
        v = torch.ones(layer.cout)
        ic._check_kernel_args(x, w, v, v, v, layer.stride, layer.dilation, layer.pad, "both",
                              torch.bfloat16)


# ----------------------------------------------------------------- build


def test_build_target_changes_with_a_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in ("int8_conv", "gemm_sm90", "nms")}
    assert before == {n: _build._target(n) for n in before}  # stable
    header = csrc / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// one more line\n")
    after = {n: _build._target(n) for n in before}
    for n in before:
        assert after[n] != before[n] and after[n].parent == _build.BUILD_DIR, n
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert _build._target("int8_conv") != after["int8_conv"]
