"""Operations and bytes of SSD300 and of the port's kernels: the yardstick
of every roofline share and MFU the benchmark reports.

Frozen copies of the arithmetic of the port's kernel table (``PERF.md``,
``chip_smoke.py``'s ``stem_train_bound`` and ``int8_bound``,
``tools/profile_split.py::nms_bound``), written here from the network's
shapes so that a later change to the program cannot move them.  Peaks are
NVIDIA's published dense rates of one H100 SXM at its 700 W limit.
"""
from __future__ import annotations

from .reference.ssd300 import BACKBONE, BOXES_PER_LOCATION, POOL_AFTER, STEM, TAPS

PEAK_BF16 = 989e12  # FLOP/s
PEAK_INT8 = 1979e12  # OP/s
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s of HBM3
NMS_OPS_PER_PAIR = 31  # float32 operations of one DIoU and its compare


def conv_layers(num_classes: int = 6) -> list[dict]:
    """Every conv of SSD300 at 300x300 with its input and output sizes and
    multiply-accumulates per image; ``kind`` is stem, backbone or head."""
    out, h, cin = [], 300, 3
    tap_hw = {}
    for i, (cout, k, s, p, d, _) in enumerate(BACKBONE):
        ho = (h + 2 * p - d * (k - 1) - 1) // s + 1
        out.append({"name": f"conv{i}", "kind": "stem" if i < STEM else "backbone",
                    "index": i, "cin": cin, "cout": cout, "k": k, "stride": s, "pad": p,
                    "dilation": d, "h_in": h, "h_out": ho, "macs": ho * ho * cout * k * k * cin})
        h, cin = ho, cout
        if i in TAPS:
            tap_hw[i] = (h, cout)
        if i in POOL_AFTER:
            h = (h + 1) // 2 if POOL_AFTER[i] else h // 2
    for t, kb in zip(TAPS, BOXES_PER_LOCATION):
        hh, c = tap_hw[t]
        n = kb * (4 + num_classes)
        out.append({"name": f"head{t}", "kind": "head", "cin": c, "cout": n, "k": 3,
                    "h_in": hh, "h_out": hh, "macs": hh * hh * n * 9 * c})
    return out


def model_flops(num_classes: int = 6) -> float:
    """Forward FLOP of one image (2 x MACs)."""
    return 2.0 * sum(layer["macs"] for layer in conv_layers(num_classes))


def seconds_at_peak(num_classes: int = 6, int8_backbone: bool = False) -> float:
    """Least time of one image's forward at the peaks: every conv at the
    bf16 peak, or with ``int8_backbone`` the post-stem backbone at the int8
    peak and the stem and heads at the bf16 peak."""
    t = 0.0
    for layer in conv_layers(num_classes):
        peak = PEAK_INT8 if int8_backbone and layer["kind"] == "backbone" else PEAK_BF16
        t += 2.0 * layer["macs"] / peak
    return t


def stem_bound_s(batch: int) -> float:
    """B2 (conv1_1 + conv1_2 + pool at ``batch``): operations at the bf16
    peak against image in, pooled map out and weights, each once."""
    ops = 2 * batch * 300 * 300 * 64 * (27 + 576)
    nbytes = (batch * 300 * 300 * 3 * 2 + batch * 150 * 150 * 64 * 2
              + (64 * 27 + 64 * 576) * 2 + 128 * 4)
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def stem_train_bound_s(batch: int) -> float:
    """B3 (the stem's forward and backward with BatchNorm): the five
    contractions at the bf16 peak against the inputs read once and the
    outputs written once."""
    ops = 2 * batch * 300 * 300 * 64 * (27 + 576 + 576 + 576 + 27)
    params = 64 * 27 + 64 * 576 + 6 * 64
    nbytes = (batch * 300 * 300 * 3 * 2 + batch * 150 * 150 * 64 * 2 * 2
              + 2 * params * 4 + 4 * 64 * 4)
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def nms_bound_s(n_valid: list[int], k: int = 400) -> float:
    """B1 on one batch: the DIoU of every pair (i valid, j > i) among the
    ``k`` sorted candidates at the float32 rate, against reading the boxes
    and the mask and writing the keep mask."""
    pairs = sum(n * (k - 1) - n * (n - 1) // 2 for n in n_valid)
    t_ops = pairs * NMS_OPS_PER_PAIR / PEAK_F32
    t_bytes = (len(n_valid) * k * (16 + 1) + len(n_valid) * k) / PEAK_BYTES
    return max(t_ops, t_bytes)


def int8_layers(num_classes: int = 6) -> list[dict]:
    """The 21 post-stem convs as the int8 kernels run them, with what each
    writes: the int8 input of the next layer, the bf16 tap of a head, or
    both."""
    layers = [layer for layer in conv_layers(num_classes) if layer["kind"] == "backbone"]
    for j, layer in enumerate(layers):
        last = j == len(layers) - 1
        tap = layer["index"] in TAPS
        layer["emit"] = "tap" if last else ("both" if tap else "int8")
    return layers


def int8_bound_s(layer: dict, batch: int) -> float:
    """One int8 conv at ``batch``: operations at the int8 peak against input,
    weights, scales and outputs moved once."""
    m = batch * layer["h_out"] ** 2
    ops = 2 * m * layer["cout"] * layer["k"] ** 2 * layer["cin"]
    out_bytes = {"int8": 1, "tap": 2, "both": 3}[layer["emit"]]
    nbytes = (batch * layer["h_in"] ** 2 * layer["cin"] + layer["k"] ** 2 * layer["cin"]
              * layer["cout"] + 12 * layer["cout"] + m * layer["cout"] * out_bytes)
    return max(ops / PEAK_INT8, nbytes / PEAK_BYTES)
