"""Check the int8 conv kernel of ``csrc/int8_conv.cu`` on one GPU, layer by layer.

    python -m ssdx_torch.tools.check_int8_conv

Builds the source and runs ``ops.int8_conv.int8_conv`` on every one of the
21 post-stem layers of the SSD300 (``quant._TOPOLOGY`` at the shapes of a
300x300 input, :func:`layers`), at full width and at width 0.25 (whose
channels of 16 and 32 take the ``cp.async`` loader), each at bs=32 and at a
ragged bs=3, with int8 operands over the full +-127 range and scales that
spread the requantized output over the int8 grid.  Each layer runs with every emit
(int8; f32 and both, each with a bf16 and an f32 tap) and each output must
equal ``int8_conv_ref`` (a float64 conv, exact, and the epilogue op by op)
bit for bit.  Prints one line per layer and batch, with the loader and
block tile of ``int8_conv.plan``, and exits non-zero on the first
disagreement, or if a loader or a built tile went unchecked.
Correctness only: ``chip_smoke.py`` phase 13 times the layers.  Needs a
CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from typing import NamedTuple

import torch

from ssdx_torch import quant
from ssdx_torch.model import backbone_channels
from ssdx_torch.ops import _build, gemm
from ssdx_torch.ops import int8_conv as ic

BATCHES = (32, 3)
WIDTHS = (1.0, 0.25)
# (emit, tap dtype) of each checked call
CALLS = (("int8", torch.bfloat16), ("f32", torch.bfloat16), ("f32", torch.float32),
         ("both", torch.bfloat16), ("both", torch.float32))


class Layer(NamedTuple):
    """One post-stem layer: its input map H x H, channels, geometry, and what
    ``apply_int8_kernels`` asks it to emit."""
    name: str
    H: int
    cin: int
    cout: int
    k: int
    stride: int
    dilation: int
    pad: int
    emit: str


def layers(width_mult: float = 1.0, size: int = 150) -> list[Layer]:
    """The 21 layers of ``quant._TOPOLOGY`` with the map each one sees when
    the stem gives a ``size`` x ``size`` map (150 for a 300x300 image)."""
    chans = backbone_channels(width_mult)
    out, H = [], size
    topo = quant._TOPOLOGY
    for i, spec in enumerate(topo):
        cin, cout = chans[int(spec.name.rsplit("_", 1)[1])]
        last = i + 1 == len(topo)
        emit = "f32" if last else ("both" if spec.tap is not None else "int8")
        out.append(Layer(spec.name, H, cin, cout, spec.kernel, spec.stride, spec.dilation,
                         spec.pad, emit))
        H = ic._out_size(H, spec.kernel, spec.stride, spec.dilation, spec.pad)
        if spec.pool:
            H = -(-H // 2) if spec.pool == "ceil" else H // 2
    return out


def layer_inputs(dev, layer: Layer, B: int, n_batches: int = 1, seed: int = 0):
    """int8 activations and weights over the full +-127 range, and scales
    that spread the requantized output over the int8 grid: ``(xs, (kernel_q,
    w_scale, bias, next_in_scale))``."""
    g = torch.Generator(device=dev).manual_seed(seed + layer.H + layer.cin)
    ri = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    ru = lambda lo, hi: torch.rand(layer.cout, generator=g, device=dev) * (hi - lo) + lo
    xs = [ri(B, layer.H, layer.H, layer.cin) for _ in range(n_batches)]
    kq = ri(layer.cout, layer.cin, layer.k, layer.k).contiguous(memory_format=torch.channels_last)
    acc_std = (layer.k * layer.k * layer.cin) ** 0.5 * 127 * 127 / 3
    ws = ru(0.5, 1.5) / acc_std
    bias = torch.randn(layer.cout, generator=g, device=dev) * 0.1
    ns = ru(0.01, 0.03)
    return xs, (kq, ws, bias, ns)


def call(fn, x, w, layer: Layer, emit: str | None = None, tap_dtype=torch.bfloat16):
    """``fn`` (``int8_conv`` or ``int8_conv_ref``) on one layer, with the
    layer's own emit unless ``emit`` is given."""
    kq, ws, bias, ns = w
    emit = emit or layer.emit
    return fn(x, kq, ws, bias, None if emit == "f32" else ns, stride=layer.stride,
              dilation=layer.dilation, pad=layer.pad, emit=emit, tap_dtype=tap_dtype)


def check_layer(dev, layer: Layer, B: int, log=print) -> ic.ConvPlan:
    """Every call of ``CALLS`` on one layer against the plain version;
    returns the layer's plan."""
    xs, w = layer_inputs(dev, layer, B)
    x = xs[0]
    refs = {t: call(ic.int8_conv_ref, x, w, layer, "both", t) for t in (torch.bfloat16, torch.float32)}
    bad = []
    for emit, t in CALLS:
        got = call(ic.int8_conv, x, w, layer, emit, t)
        q_ref, tap_ref = refs[t]
        want = {"int8": (q_ref,), "f32": (tap_ref,), "both": (q_ref, tap_ref)}[emit]
        got = got if isinstance(got, tuple) else (got,)
        for g, r in zip(got, want):
            if g.shape != r.shape or g.dtype != r.dtype or not torch.equal(g, r):
                n = int((g != r).sum()) if g.shape == r.shape else -1
                bad.append(f"emit={emit} tap={str(t)[6:]} {str(g.dtype)[6:]}: {n} mismatches")
    torch.cuda.synchronize()
    p = ic.plan(x.shape, layer.cout, layer.k, layer.stride, layer.dilation, layer.pad,
                gemm._sms(x.device.index))
    spread = refs[torch.float32][0].unique().numel()
    log(f"{layer.name} bs={B} {layer.H}x{layer.H} {layer.cin}->{layer.cout} k={layer.k} "
        f"s={layer.stride} d={layer.dilation} p={layer.pad}: {p.loader} loader, tile {p.bm}x{p.bn}, "
        f"{p.tiles} tiles ({p.waves:.2f} waves), {p.nk} k-blocks; "
        + ("; ".join(bad) if bad else f"{len(CALLS)} calls equal bit for bit") +
        f" ({spread} distinct int8 values)")
    if bad:
        raise AssertionError(f"{layer.name} bs={B}: " + "; ".join(bad))
    return p


def run(log=print) -> int:
    """Every layer at every width and batch size; returns the number of
    checked calls.  Fails unless the plans took every loader and every
    (tile, blocks an SM, k-block) the kernel is built for."""
    dev = torch.device("cuda")
    n, seen = 0, set()
    for width in WIDTHS:
        for B in BATCHES:
            for layer in layers(width):
                p = check_layer(dev, layer, B, log)
                seen |= {p.loader, (p.bm, p.bn, p.ctas, p.kb)}
                n += len(CALLS)
                torch.cuda.empty_cache()
    missed = (set(ic.LOADERS) | set(ic.BUILT)) - seen
    if missed:
        raise AssertionError(f"no layer took {sorted(map(str, missed))}")
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("check_int8_conv: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    _build.build("int8_conv")
    for line in _build.build_logs.get("int8_conv", "").splitlines():
        if "registers" in line or "spill" in line or "warning" in line:
            print(f"  ptxas[int8_conv]: {line.strip()}")
    n = run()
    print(f"check_int8_conv: all {n} calls equal their plain version bit for bit "
          f"({len(layers())} layers at widths {' and '.join(map(str, WIDTHS))}, "
          f"bs={' and '.join(map(str, BATCHES))}), every loader and built tile among them")
    return 0


if __name__ == "__main__":
    sys.exit(main())
