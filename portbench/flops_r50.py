"""Operations and bytes of NVIDIA's SSD300 v1.1 (ResNet-50 trunk) and of
B1's per-class IoU pass: the yardstick of the ``.r50`` roofline and MFU
readers.

Written from the network's shapes (``reference/ssd300_resnet50.py``), so
that a later change to the program cannot move them.  Peaks are NVIDIA's
published dense rates of one H100 SXM at its 700 W limit (``flops.py``).
"""
from __future__ import annotations

from .flops import PEAK_BF16, PEAK_BYTES, PEAK_F32
from .reference.ssd300_resnet50 import BOXES_PER_LOCATION, FEATURE_MAPS, layout, tap_channels

IOU_OPS_PER_PAIR = 14  # float32 operations of one IoU (areas precomputed) and its compare
LABEL_OPS_PER_PAIR = 1  # the label compare every pair (i valid, j > i) takes
BYTES = 2  # bf16 activations and weights


def _out(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def conv_layers(num_classes: int = 81) -> list[dict]:
    """Every conv at 300x300 with its input and output sizes, its
    multiply-accumulates per image and its bytes per image (input, output
    and weights once, in bf16); ``kind`` is trunk, extras or head."""
    out = []
    side = {}  # the block's input ("in"), its mid conv's output ("mid")
    for path, cin, cout, k, stride, pad in layout():
        last = path.rsplit(".", 1)[1]
        if path == "trunk.conv1":
            h_in = 300
        elif last in ("conv1", "0"):  # a block starts on the last block's output
            side["in"] = h_in = side.get("out", side.get("in"))
        else:
            h_in = side["mid"] if last in ("conv3", "1") else side["in"]
        ho = _out(h_in, k, stride, pad)
        out.append({"name": path, "kind": path.split(".")[0], "cin": cin, "cout": cout, "k": k,
                    "stride": stride, "h_in": h_in, "h_out": ho,
                    "macs": ho * ho * cout * k * k * cin,
                    "bytes": BYTES * (h_in * h_in * cin + ho * ho * cout + k * k * cin * cout)})
        if path == "trunk.conv1":
            side["in"] = _out(ho, 3, 2, 1)  # the max pool
        elif last in ("conv2", "0"):
            side["mid"] = ho
        elif last in ("conv3", "1"):
            side["out"] = ho
    for i, (c, nd, hh) in enumerate(zip(tap_channels(), BOXES_PER_LOCATION, FEATURE_MAPS)):
        n = nd * (4 + num_classes)
        out.append({"name": f"head{i}", "kind": "head", "cin": c, "cout": n, "k": 3, "stride": 1,
                    "h_in": hh, "h_out": hh, "macs": hh * hh * n * 9 * c,
                    "bytes": BYTES * (hh * hh * c + hh * hh * n + 9 * c * n)})
    return out


def model_flops(num_classes: int = 81) -> float:
    """Forward FLOP of one image (2 x MACs)."""
    return 2.0 * sum(layer["macs"] for layer in conv_layers(num_classes))


def seconds_at_peak(num_classes: int = 81) -> float:
    """Least time of one image's forward with every conv at the bf16 peak."""
    return model_flops(num_classes) / PEAK_BF16


def conv_bound_s(batch: int, num_classes: int = 81) -> float:
    """Least time of a batch's convs: each the larger of its operations at
    the bf16 peak and its bytes (activations per image, weights once) at
    the HBM rate."""
    t = 0.0
    for layer in conv_layers(num_classes):
        wbytes = BYTES * layer["k"] ** 2 * layer["cin"] * layer["cout"]
        nbytes = batch * (layer["bytes"] - wbytes) + wbytes
        t += max(batch * 2.0 * layer["macs"] / PEAK_BF16, nbytes / PEAK_BYTES)
    return t


def nms_iou_bound_s(n_valid: list[int], same_class_pairs: list[int], k: int) -> float:
    """B1 on one batch of per-class IoU-NMS: a label compare for every pair
    (i valid, j > i) among the ``k`` sorted candidates, and the IoU of the
    same-class ones, at the float32 rate; against reading boxes, labels and
    the mask and writing the keep mask."""
    pairs = sum(n * (k - 1) - n * (n - 1) // 2 for n in n_valid)
    ops = pairs * LABEL_OPS_PER_PAIR + sum(same_class_pairs) * IOU_OPS_PER_PAIR
    t_bytes = len(n_valid) * k * (16 + 4 + 1 + 1) / PEAK_BYTES
    return max(ops / PEAK_F32, t_bytes)
