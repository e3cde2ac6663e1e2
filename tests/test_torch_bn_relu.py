"""The pool-free twin of the BN + ReLU + pool kernels
(``ssdx_torch.ops.bn_relu_pool.bn_relu``, ``csrc/bn_relu_pool.cu`` with
``POOL = false``) and its route through ``model.ConvBNRelu``.

On the CPU:
* the plain version ``bn_relu_ref`` against the autograd of ConvBNRelu's
  train-mode arithmetic (the sums, ``(y - mean) * rsqrt(var + eps) * gamma +
  beta``, ReLU), in y, the statistics, dx, dgamma and dbeta, at width-0.25
  channel counts: the two round in other places, so within 1e-5 of each
  output's largest magnitude in float32;
* the ReLU boundary takes no gradient; gradcheck in float64; the wrapper
  refuses C % 8 != 0, C > 2048 and what B6's wrapper refuses, on every device;
* a model of pipe_kernel's pool-free walk from ``flat_tiles``: every pixel
  taken exactly once and only from the bytes the producer copied, the stores
  covering every copied byte, at the 18 layer shapes and at odd ones; the
  partial rows bit for bit the same on any grid; the four passes and the two
  finalize kernels, in float32 in the kernels' order, equal the plain
  version; the tiles fit the ring for every C the contract takes;
* ``check_brp.LAYER_SHAPES`` are the shapes of the train step's 18 BN layers
  outside the stem (the model traced on the meta device);
* ``SSD300.forward(train=True)`` on the CPU, without and with a one-rank
  mesh, gives the bits of the plain route as it was before the kernels (a
  frozen copy of it below): heads, gradients and running statistics;
* the train step's span counts ``bn_layers`` and ``bn_fused``, and the reader
  of ``bn_fused_share.train``.

On a CUDA card (``chip``; skipped without one): the kernels against the plain
version at the 10 distinct layer shapes in bf16 and f32 within
``tools/check_brp.py``'s limits, two runs bit for bit; a train step of the
full-width model launching the kernels 18 times forward and 18 backward, its
span counting 18 of 18, replayed steps too.  Run there with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bn_relu.py``.
This file imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from portbench import core
from portbench.trace import DeviceOp, Trace
from ssdx_torch import priors as P
from ssdx_torch.mesh import Mesh
from ssdx_torch.model import _POOL_AFTER, _TAPS, SSD300, init_variables, update_running_stats
from ssdx_torch.ops import bn_relu_pool as brp
from ssdx_torch.tools import check_brp
from ssdx_torch.train import step as step_mod
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_train_step
from ssdx_torch.utils import profiling
from ssdx_torch.utils.profiling import SpanRecord
from ssdx_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
SRC = (ROOT / "ssdx_torch" / "csrc" / "bn_relu_pool.cu").read_text()
STEP = "ssdx_torch.train.step"
METRIC = "bn_fused_share.train"
f32 = np.float32


def _const(name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, name
    return m.group(1)


CONSUMERS, ROW_ELEMS = int(_const("kConsumers")), int(_const("kRowElems"))
RING = int(_const("kRingBytes"))
assert _const("kStageElems") == "2 * kRowElems + kRowElems / 2"
STAGE_ELEMS = 2 * ROW_ELEMS + ROW_ELEMS // 2
FIN_GROUPS = 1024 // (2 * int(_const("kFinChannels")))
GRIDS = (1, 3, 7, 2 * 114, 2 * 132)  # and the H100 PCIe's and SXM's persistent grids
LAYERS = tuple(dict.fromkeys(check_brp.LAYER_SHAPES))  # the 10 distinct shapes
ODD = ((1, 1, 1, 8), (3, 7, 9, 24), (2, 5, 13, 2048), (1, 3, 5, 16), (2, 7, 11, 136))


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(0.1, 1.0, shape).astype(dtype), rng.normal(1, 0.2, C).astype(dtype),
            rng.normal(0, 0.2, C).astype(dtype), rng.normal(size=shape).astype(dtype))


def _grads(fn, x, gamma, beta, dy):
    """fn's y, mean and var and the gradients of x, gamma, beta for the
    cotangent dy of y."""
    leaves = [torch.as_tensor(a).requires_grad_() for a in (x, gamma, beta)]
    y, mean, var = fn(*leaves)
    y.backward(torch.as_tensor(dy))
    return [t.detach().numpy() for t in (y, mean, var)] + [t.grad.numpy() for t in leaves]


def _module_arithmetic(x, gamma, beta):
    """ConvBNRelu's train-mode BN + ReLU on the NCHW view of NHWC x, as the
    plain route computes it: (y, mean, var)."""
    yf = x.permute(0, 3, 1, 2).float()
    n = yf.numel() // yf.shape[1]
    s1, s2 = yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    mul = torch.rsqrt(var + 1e-5) * gamma
    y = (yf - mean[:, None, None]) * mul[:, None, None] + beta[:, None, None]
    return F.relu(y).permute(0, 2, 3, 1), mean, var


# ---------------------------------------------------------- the plain version


@pytest.mark.parametrize("shape", [(2, 9, 11, 32), (2, 6, 7, 64), (3, 5, 5, 128), (2, 4, 3, 256)])
def test_plain_version_equals_the_autograd_of_the_module_arithmetic(shape):
    x, gamma, beta, dy = _inputs(shape, seed=shape[-1])
    got = _grads(brp.bn_relu_ref, x, gamma, beta, dy)
    want = _grads(_module_arithmetic, x, gamma, beta, dy)
    for name, k, r in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), got, want):
        assert k.shape == r.shape, name
        assert np.abs(k - r).max() <= 1e-5 * np.abs(r).max(), name


def test_relu_boundary_takes_no_gradient():
    """gamma = 0 and beta = 0 make every y exactly 0: no gradient passes."""
    x, _, _, dy = _inputs((1, 4, 4, 8), seed=6)
    xt = torch.as_tensor(x).requires_grad_()
    gamma, beta = torch.zeros(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    y, _, _ = brp.bn_relu(xt, gamma, beta)
    y.backward(torch.as_tensor(dy))
    assert float(y.detach().abs().max()) == 0.0
    for g in (xt.grad, gamma.grad, beta.grad):
        assert float(g.abs().max()) == 0.0


def test_wrapper_on_cpu_takes_the_plain_route_and_gradcheck():
    before = (brp.launches_bn_relu, brp.launches_bn_relu_bwd)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(2, 3, 5, 8))).requires_grad_()
    gamma = torch.as_tensor(rng.normal(1, 0.2, 8)).requires_grad_()
    beta = torch.as_tensor(rng.normal(0, 0.2, 8)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, g, b: brp.bn_relu(a, g, b, 1e-5),
                                    (x, gamma, beta), eps=1e-6, atol=1e-5)
    assert (brp.launches_bn_relu, brp.launches_bn_relu_bwd) == before  # no kernel on the CPU
    y, mean, var = brp.bn_relu(x, gamma, beta)
    y.sum().backward()  # missing cotangents of mean and var count as zeros
    assert torch.isfinite(x.grad).all() and mean.dtype == var.dtype == torch.float64
    assert y.shape == x.shape and y.dtype == x.dtype


@pytest.mark.parametrize("C", [12, 2056])
def test_wrapper_refuses_what_the_kernels_do_not_take(C):
    with pytest.raises(ValueError, match="C % 8 == 0 and C <= 2048"):
        brp.bn_relu(torch.zeros((1, 2, 2, C)), torch.ones(C), torch.ones(C))
    with pytest.raises(ValueError, match="gamma, beta"):
        brp.bn_relu(torch.zeros((1, 4, 4, 8)), torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="unsupported device"):
        g = torch.ones(8, device="meta")
        brp.bn_relu(torch.zeros((1, 4, 4, 8), device="meta"), g, g)
    with pytest.raises(ValueError, match="share a device"):
        brp.bn_relu(torch.zeros((1, 4, 4, 8), device="meta"), torch.ones(8), torch.ones(8))


# ------------------------------------------- a model of the pool-free walk


def walk(t, grid):
    """Per block, its tiles (band, q) in the order it reads them."""
    return [[(band, q) for band in range(blk, t["nbands"], grid) for q in range(t["nq"])]
            for blk in range(grid)]


def tile(t, band, q):
    """(first pixel, copied pixels, pixels [slots, 2], taken [slots, 2]) of a
    tile: thread (slot, cg) takes pixels c0 + 2*slot and c0 + 2*slot + 1."""
    N, tw = t["W"], t["tw"]
    c0 = (band * t["nq"] + q) * tw
    ncol = max(0, min(tw, N - c0))
    pix = c0 + 2 * np.arange(t["slots"])[:, None] + np.arange(2)[None, :]
    return c0, ncol, pix, pix < N


@pytest.mark.parametrize("shape", LAYERS + ODD)
def test_every_pixel_once_from_the_copied_bytes(shape):
    B, H, W, C = shape
    t = brp.flat_tiles(B, H, W, C)
    N = B * H * W
    assert (t["B"], t["H"], t["W"], t["C"]) == (1, 1, N, C)
    assert t["tw"] * C <= ROW_ELEMS and t["slots"] * t["G"] <= CONSUMERS
    assert (t["nbands"] - 1) * t["nq"] * t["tw"] < N <= t["nbands"] * t["nq"] * t["tw"]
    for grid in (5, min(GRIDS[-1], t["nbands"])):
        blocks = walk(t, grid)
        seen = sorted(bq for blk in blocks for bq in blk)
        assert seen == [(b, q) for b in range(t["nbands"]) for q in range(t["nq"])]
        taken = []
        for blk in blocks:
            for band, q in blk:
                c0, ncol, pix, inside = tile(t, band, q)
                local = pix - c0
                assert (local[inside] < ncol).all()  # from the copied bytes only
                # the stores (apply's y, dx) cover every copied pixel
                assert sorted(local[inside].tolist()) == list(range(ncol))
                taken.append(pix[inside])
        taken = np.concatenate(taken)
        assert len(taken) == N and (np.sort(taken) == np.arange(N)).all()  # each pixel once


def fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def bn_relu_f32(v, a, c):
    return np.maximum((v * a).astype(f32) + c, f32(0))


def pipe(mode, x, t, grid, vec=None, fin=None, dy=None):
    """pipe_kernel<float, mode, false> over ``grid`` blocks on the flat map x
    [N, C]: part rows (stats, reduce) or the output (apply: y, dx: dx)."""
    N, C, S = x.shape[0], x.shape[1], t["slots"]
    part = np.full((t["nbands"], 2 * C), np.nan, f32)
    out = np.full(x.shape, np.nan, f32)
    for blocks in walk(t, grid):
        for n, (band, q) in enumerate(blocks):
            if q == 0:
                s1, s2 = np.zeros((S, C), f32), np.zeros((S, C), f32)
            _, _, pix, inside = tile(t, band, q)
            v = np.zeros((S, 2, C), f32)
            v[inside] = x[pix[inside]]
            if mode == "stats":
                for i in range(2):
                    ok = inside[:, i][:, None]
                    s1 = np.where(ok, s1 + v[:, i], s1)
                    s2 = np.where(ok, fma(v[:, i], v[:, i], s2), s2)
            else:
                y = bn_relu_f32(v, vec[0], vec[1])
                if mode == "apply":
                    out[pix[inside]] = y[inside]
                else:
                    d = np.zeros((S, 2, C), f32)
                    d[inside] = dy[pix[inside]]
                    dm = np.where(inside[:, :, None] & (y > 0), d, f32(0))
                    xm = (v - vec[3]).astype(f32)
                    if mode == "reduce":
                        for i in range(2):
                            ok = inside[:, i][:, None]
                            s1 = np.where(ok, s1 + dm[:, i], s1)
                            s2 = np.where(ok, fma(dm[:, i], xm[:, i], s2), s2)
                    else:
                        r = fma(vec[0], dm, fma(xm, fin[2], fin[3]))
                        out[pix[inside]] = r[inside]
            last = n + 1 == len(blocks) or blocks[n + 1][0] != band
            if last and mode in ("stats", "reduce"):
                acc = np.zeros((2, C), f32)
                for j in range(S):  # the slots, in order
                    acc[0] += s1[j]
                    acc[1] += s2[j]
                part[band] = acc.reshape(-1)
    return part if mode in ("stats", "reduce") else out


def column_sums(part):
    """The finalize kernels' fixed tree (csrc/bn_relu_pool.cu column_sums)."""
    groups = np.zeros((FIN_GROUPS, part.shape[1]), f32)
    for k in range(FIN_GROUPS):
        for row in range(k, part.shape[0], FIN_GROUPS):
            groups[k] += part[row]
    stride = FIN_GROUPS // 2
    while stride:
        groups[:stride] += groups[stride:2 * stride]
        stride //= 2
    return groups[0]


def model(x, gamma, beta, dy, grid, eps=1e-5):
    """The forward and backward as the kernels run them: y, mean, var, dx,
    dgamma, dbeta (the cotangents of mean and var zero, as the step's)."""
    B, H, W, C = x.shape
    t = brp.flat_tiles(B, H, W, C)
    xf, dyf, n = x.reshape(-1, C), dy.reshape(-1, C), f32(B * H * W)
    sums = column_sums(pipe("stats", xf, t, grid))
    mu = sums[:C] / n
    var = np.maximum(sums[C:] / n - mu * mu, f32(0))
    inv = (1 / np.sqrt(var.astype(np.float64) + eps)).astype(f32)
    a = gamma * inv
    vec = np.stack([a, beta - mu * a, inv, mu]).astype(f32)
    y = pipe("apply", xf, t, grid, vec=vec)
    sums = column_sums(pipe("reduce", xf, t, grid, vec=vec, dy=dyf))
    s1, s2 = sums[:C], sums[C:] * inv
    fin = np.stack([s1, s2, -a * inv * (s2 / n), -a * (s1 / n)]).astype(f32)
    dx = pipe("dx", xf, t, grid, vec=vec, fin=fin, dy=dyf)
    return [y.reshape(x.shape), mu, var, dx.reshape(x.shape), s2, s1]


@pytest.mark.parametrize("shape", [(2, 10, 130, 64), (2, 5, 37, 24)])
def test_partial_rows_do_not_depend_on_the_grid(shape):
    x, gamma, beta, dy = _inputs(shape, seed=1)
    runs = [model(x, gamma, beta, dy, grid) for grid in GRIDS]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert a.tobytes() == b.tobytes()  # bit for bit


@pytest.mark.parametrize("shape", [(2, 10, 130, 64), (2, 8, 70, 128), (2, 7, 37, 256),
                                   (3, 9, 11, 24), (2, 3, 5, 1024)])
def test_model_equals_plain_version(shape):
    """The modelled passes (float32, the kernels' order) against bn_relu_ref."""
    x, gamma, beta, dy = _inputs(shape, seed=2)
    got = model(x, gamma, beta, dy, 7)
    want = _grads(brp.bn_relu_ref, x, gamma, beta, dy)
    assert not any(np.isnan(a).any() for a in got)  # every output element written
    rel = lambda k, r: np.abs(k - r).max() / (np.abs(r).max() + 1e-12)
    for name, k, r in zip(("y", "mean", "var"), got[:3], want[:3]):
        assert rel(k, r) < 1e-5, name
    assert np.linalg.norm(got[3] - want[3]) / np.linalg.norm(want[3]) < 1e-4
    assert rel(got[4], want[4]) < 1e-4 and rel(got[5], want[5]) < 1e-4


def test_ring_and_tiles_fit_every_channel_count():
    """For every C % 8 == 0 up to 2048 a tile's x and dy fit a stage side by
    side, every bulk copy is a whole number of 16 bytes, and a band's partial
    row (8 C bytes) stays within an eighth of the x it reads in bfloat16."""
    assert 2 * ROW_ELEMS <= STAGE_ELEMS
    for C in range(8, 2049, 8):
        t = brp.flat_tiles(16, 19, 19, C)
        assert t["tw"] % 2 == 0 and t["tw"] * C <= ROW_ELEMS and t["slots"] * t["G"] <= CONSUMERS
        assert (C * 2) % 16 == 0  # a pixel in bfloat16, so every copy and store
        assert 8 * (8 * C) <= t["nq"] * t["tw"] * C * 2


def test_the_kernels_keep_the_trace_groups_of_the_glue():
    """The kernels' names carry no key that portbench.trace.train_group
    reads as a convolution or as B3, so step_glue_ms.train counts them as it
    counted the PyTorch ops they replace."""
    from portbench.trace import B3_KERNELS, _CONV_KEYS, train_group
    names = re.findall(r"__global__ void[^\n]*\n(\w+)\(", SRC)
    assert set(names) == {"pipe_kernel", "stats_finalize_kernel", "reduce_finalize_kernel"}
    for name in names:
        assert not any(k in name.lower() for k in _CONV_KEYS + B3_KERNELS), name
        assert train_group(f"(anonymous namespace)::{name}<__nv_bfloat16, 3, false>(x)") in (
            "elementwise", "reduction")


# -------------------------------------------------- the shapes and the route


def test_layer_shapes_are_the_train_steps_bn_layers():
    shapes = {}
    with torch.device("meta"):
        model = SSD300(6)
    for i, layer in enumerate(model.layers):
        if layer.bn is not None and i >= 2:
            layer.register_forward_hook(
                lambda m, a, out, i=i: shapes.__setitem__(i, tuple(out.permute(0, 2, 3, 1).shape)))
    model(torch.empty(16, 300, 300, 3, device="meta"), train=True)
    assert sorted(shapes) == list(range(2, 20))
    assert tuple(shapes[i] for i in range(2, 20)) == check_brp.LAYER_SHAPES


def _parent_forward(model, images):
    """SSD300.forward(train=True) as the plain route computed it before the
    kernels, a frozen copy: conv, the module arithmetic, the running
    statistics' update, ReLU, the pools, the heads."""
    x = images.permute(0, 3, 1, 2).to(model.dtype)
    taps = []
    for i, layer in enumerate(model.layers):
        c, bn = layer.conv, layer.bn
        y = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding,
                     c.dilation)
        if bn is not None:
            yf = y.float()
            n = yf.numel() // yf.shape[1]
            s1, s2 = yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            update_running_stats(bn, mean.detach(), var.detach())
            mul = torch.rsqrt(var + bn.eps) * bn.weight
            y = ((yf - mean[:, None, None]) * mul[:, None, None]
                 + bn.bias[:, None, None]).to(x.dtype)
        x = F.relu(y)
        if i in _TAPS:
            taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=_POOL_AFTER[i])
    return model.heads(taps)


def _twin(dtype):
    model = SSD300(6, width_mult=0.25, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(init_variables(6, 3, 0.25), False))
    return model


@pytest.mark.parametrize("route,dtype", [("plain", torch.float32), ("plain", torch.bfloat16),
                                         ("mesh", torch.float32)])
def test_cpu_and_mesh_routes_keep_the_parents_bits(route, dtype):
    images = torch.as_tensor(np.random.default_rng(4).normal(size=(1, 300, 300, 3)),
                             dtype=torch.float32)
    mesh = Mesh(None, 1, 0, torch.device("cpu")) if route == "mesh" else None
    got, want = _twin(dtype), _twin(dtype)
    outs = got(images, train=True, mesh=mesh), _parent_forward(want, images)
    for model, (loc, cls) in zip((got, want), outs):
        (loc.square().mean() + cls.square().mean()).backward()
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for (k, a), (_, b) in zip(got.named_parameters(), want.named_parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), (_, b) in zip(got.named_buffers(), want.named_buffers()):
        assert torch.equal(a, b), k


def _state(width_mult, dev, dtype=torch.float32, seed=0):
    model = SSD300(6, width_mult=width_mult, dtype=dtype).to(dev,
                                                              memory_format=torch.channels_last)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=10, max_epochs=2,
                                 warmup_epochs=0, base_lr=1e-2)
    return create_train_state(model, opt, sched, init_variables(6, seed, width_mult))


def _batch(seed, B, dev, G=6):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.6, (B, G, 2))
    sz = rng.uniform(0.05, 0.3, (B, G, 2))
    arrays = (rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32),
              np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1).astype(np.float32),
              rng.integers(0, 5, (B, G)).astype(np.int32), rng.uniform(0, 1, (B, G)) < 0.8)
    return Batch(*(torch.as_tensor(a, device=dev) for a in arrays))


def _counted_step(step, state, batch):
    """One step under a CPU profiler: the step span's counts."""
    profiling.recent_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, batch)
    (rec,) = [r for r in profiling.recent_spans() if r.name == STEP]
    return rec.counts


def test_the_step_counts_its_bn_layers_and_the_fused_ones(monkeypatch):
    """At width 0.25 on the CPU all 20 BN layers run through ConvBNRelu (no
    stem kernel), none on the kernels; bn_fused is the launch counter's
    movement over the step, whoever moves it."""
    pri = P.create_priors()
    state = _state(0.25, "cpu")
    step = make_train_step(state.model, pri, P.priors_xyxy(pri), iou_thresh=0.4)
    assert _counted_step(step, state, _batch(0, 1, "cpu")) == {
        "steps": 1, "replayed": 0, "bn_layers": 20, "bn_fused": 0}
    real = step_mod.build_targets

    def launching(*a, **k):
        brp.launches_bn_relu += 7
        return real(*a, **k)

    monkeypatch.setattr(step_mod, "build_targets", launching)
    monkeypatch.setattr(brp, "launches_bn_relu", brp.launches_bn_relu)
    assert _counted_step(step, state, _batch(1, 1, "cpu"))["bn_fused"] == 7


def _rec(i, **counts):
    return SpanRecord(STEP, i, 0, i, 1, 1000 * i, 1000 * i + 500, counts)


def test_the_fused_share_reads_the_step_span_counts(monkeypatch):
    assert METRIC in {m["name"] for m in core.load_cell("train_bs16", ROOT).per_layer}
    trace = Trace(window_s=0.1, busy_s=0.09, ops=[DeviceOp("k", "kernel", 10, 5)])
    logs = {
        100.0: [_rec(i, steps=1, replayed=1, bn_layers=18, bn_fused=18) for i in range(1, 5)],
        50.0: [_rec(1, steps=1, bn_layers=18, bn_fused=18), _rec(2, steps=1, bn_layers=18,
                                                              bn_fused=0)],
        None: [_rec(1, steps=1, replayed=1), _rec(2, steps=1, replayed=1)],  # the parent's
    }
    for want, log in logs.items():
        monkeypatch.setattr(profiling, "recent_spans", lambda log=log: list(log))
        ctx = core.Context(cell=core.load_cell("train_bs16", ROOT), trace=trace, traced_iters=2)
        got = core.per_layer_metrics(ctx, ROOT).get(METRIC)
        if want is None:
            assert got is None
        else:
            assert got == {"value": pytest.approx(want), "unit": "%"}
    ctx = core.Context(cell=core.load_cell("train_bs16", ROOT), trace=None, traced_iters=2)
    assert core.reader(METRIC, ROOT)(ctx) is None  # no traced window: a run off the card


# ---- on the card ----

chip = pytest.mark.chip  # the benchmark's marker of tests that need a card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", LAYERS)
def test_kernels_equal_plain_version_at_the_layer_shapes(cuda, shape, dtype):
    """tools/check_brp.py's limits and two runs bit for bit (it raises)."""
    check_brp.check_bn_relu_case(cuda, shape, dtype, 40 + LAYERS.index(shape), log=print)


@chip
def test_a_train_step_runs_its_18_bn_layers_on_the_kernels(cuda):
    """Full width with the stem kernel, bs=4: an eager step, the captured
    one and two replays each launch the kernels 18 times forward and 18
    backward, and the step's span counts 18 of 18."""
    pri = P.create_priors()
    state = _state(1.0, cuda, torch.bfloat16, seed=7)
    step = make_train_step(state.model, pri, P.priors_xyxy(pri), iou_thresh=0.4)
    for i in range(4):
        before = (brp.launches_bn_relu, brp.launches_bn_relu_bwd)
        counts = _counted_step(step, state, _batch(50 + i, 4, cuda))
        torch.cuda.synchronize()
        assert counts == {"steps": 1, "replayed": int(i > 0), "bn_layers": 18, "bn_fused": 18}
        assert (brp.launches_bn_relu - before[0], brp.launches_bn_relu_bwd - before[1]) == (18, 18)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
