"""Visualization: GT/prediction overlays, side-by-side prediction panels,
loss-curve plots.

The port's own copy of ``ssdx/viz.py``: ``show_with_box`` (one image with
its GT boxes and optional predictions), ``side_by_side_prediction`` (the demo
app's render path: EXIF fix, predict at 300x300, resize the original to
``target_height`` preserving aspect with LANCZOS, red boxes with white-on-red
class chips, original | annotated) and ``plot_losses`` (the 2x2 curves of a
``fit`` results dict).  Host-side matplotlib and PIL, imported where they are
used; tensors are accepted wherever arrays are.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from .model import IMAGE_SIZE

__all__ = ["show_with_box", "side_by_side_prediction", "plot_losses"]


def _to_hwc_uint8(img) -> np.ndarray:
    """Accept PIL / ndarray / tensor, CHW or HWC, float [0,1] or uint8."""
    try:
        from PIL import Image

        if isinstance(img, Image.Image):
            return np.asarray(img.convert("RGB"))
    except ImportError:
        pass
    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))
    if arr.dtype.kind == "f":
        if arr.max() <= 1.0:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    elif arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


def _as_xyxy(x) -> np.ndarray | None:
    if x is None:
        return None
    arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    assert arr.shape[1] == 4, f"expected (...,4) boxes, got {arr.shape}"
    return arr


def show_with_box(
    img,
    target: dict,
    class_to_idx: dict[str, int] | None = None,
    color: str = "g",
    lw: int = 2,
    label: bool = False,
    pred_dict: dict | None = None,
    pred_color: str = "r",
    lw_pred: int = 2,
    pred_label: bool = False,
    pred_ref: Literal["size", "normalized", "current"] = "size",
    pred_size: tuple[int, int] = (IMAGE_SIZE, IMAGE_SIZE),
):
    """Render one image with GT boxes (green) and optional predictions (red).

    ``pred_ref`` selects the predicted-box coordinate reference frame:
    "size" = pixel coords of a (H_ref, W_ref) frame, "normalized" = [0,1]
    of the displayed image, "current" = already display pixels.
    Returns the matplotlib Figure.
    """
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    arr = _to_hwc_uint8(img)
    H, W = arr.shape[:2]
    fig, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.imshow(arr)

    idx_to_name = {v: k for k, v in (class_to_idx or {}).items()}

    def _draw(boxes, labels, col, width, with_labels, va, ha, anchor):
        for i in range(boxes.shape[0]):
            x1, y1 = max(0.0, boxes[i, 0]), max(0.0, boxes[i, 1])
            x2 = min(W - 1.0, boxes[i, 2])
            y2 = min(H - 1.0, boxes[i, 3])
            if not (x2 > x1 and y2 > y1):
                continue
            ax.add_patch(
                Rectangle((x1, y1), x2 - x1, y2 - y1, linewidth=width,
                          edgecolor=col, facecolor="none")
            )
            if with_labels and labels is not None:
                lab = int(labels[i])
                name = idx_to_name.get(lab, str(lab))
                tx, ty = (x1, y1) if anchor == "tl" else (x2, y2)
                ax.text(tx, ty, name, fontsize=10, color="white", va=va, ha=ha,
                        bbox=dict(facecolor=col, alpha=0.6, pad=2, edgecolor="none"))

    gt_boxes = _as_xyxy(target.get("boxes"))
    if gt_boxes is not None and len(gt_boxes):
        _draw(gt_boxes, target.get("labels"), color, lw, label, "bottom", "right", "tl")

    if pred_dict:
        pb = _as_xyxy(pred_dict["boxes"])
        if pred_ref == "current":
            pass
        elif pred_ref == "normalized":
            pb = pb * np.array([W, H, W, H], np.float32)
        elif pred_ref == "size":
            href, wref = pred_size
            if href <= 0 or wref <= 0:
                raise ValueError(f"Invalid pred_size={pred_size}.")
            pb = pb * np.array([W / wref, H / href, W / wref, H / href], np.float32)
        else:
            raise ValueError(f"Unsupported pred_ref={pred_ref}")
        _draw(pb, pred_dict.get("labels"), pred_color, lw_pred, pred_label,
              "top", "left", "br")

    ax.axis("off")
    return fig


def side_by_side_prediction(
    detector,
    image_path: str | None = None,
    pil_img=None,
    score_thresh: float = 0.2,
    nms_thresh: float = 0.5,
    max_per_img: int = 100,
    class_agnostic: bool = False,
    target_height: int = 512,
):
    """Original | annotated panels as one PIL image.  ``detector`` is
    anything with ``predict_pil`` and ``idx_to_class`` (a Detector or a
    MicroBatcher)."""
    from PIL import Image, ImageDraw, ImageFont, ImageOps

    if (image_path is not None) == (pil_img is not None):
        raise TypeError(
            "An image path or PIL image should be supplied, not both or neither."
        )
    pil_orig = Image.open(image_path).convert("RGB") if image_path else pil_img.convert("RGB")
    pil_orig = ImageOps.exif_transpose(pil_orig)
    orig_w, orig_h = pil_orig.size
    if orig_h == 0:
        raise ValueError("Original image has zero height.")

    pred = detector.predict_pil(
        pil_orig,
        score_thresh=score_thresh,
        nms_thresh=nms_thresh,
        max_per_img=max_per_img,
        class_agnostic=class_agnostic,
    )

    out_h = target_height
    out_w = max(1, int(round(out_h * orig_w / orig_h)))
    pil_disp = pil_orig.resize((out_w, out_h), Image.LANCZOS)

    annotated = pil_disp.copy()
    draw = ImageDraw.Draw(annotated)
    sx, sy = out_w / IMAGE_SIZE, out_h / IMAGE_SIZE
    try:
        font = ImageFont.truetype("arial.ttf", size=14)
    except OSError:
        font = ImageFont.load_default()

    for box, lab, _score in zip(pred["boxes"], pred["labels"], pred["scores"]):
        x1, y1, x2, y2 = box[0] * sx, box[1] * sy, box[2] * sx, box[3] * sy
        draw.rectangle([x1, y1, x2, y2], outline="red", width=2)
        text = detector.idx_to_class.get(int(lab), str(int(lab)))
        tb = draw.textbbox((0, 0), text, font=font)
        tw, th, ymin = tb[2] - tb[0], tb[3] - tb[1], tb[1]
        top = max(y1 - th, 0)
        draw.rectangle([x1, top, x1 + tw, top + th], fill="red")
        draw.text((x1, top - ymin), text, fill="white", font=font)

    combined = Image.new("RGB", (2 * out_w, out_h))
    combined.paste(pil_disp, (0, 0))
    combined.paste(annotated, (out_w, 0))
    return combined


def plot_losses(losses: dict, figsize=(10, 8)):
    """2x2 grid: total loss, mAP@0.5, classification loss, localization loss;
    validates keys, finiteness and equal lengths.  Returns the Figure."""
    import matplotlib.pyplot as plt

    series_keys = [
        "train_loss", "train_loss_loc", "train_loss_conf",
        "test_loss", "test_loss_loc", "test_loss_conf",
    ]
    required = series_keys + ["mAP"]
    missing = [k for k in required if k not in losses]
    if missing:
        raise KeyError(f"Missing keys: {missing}")
    lens = []
    for k in series_keys:
        v = losses[k]
        if not isinstance(v, (list, tuple)):
            raise TypeError(f"Value for '{k}' must be a list/tuple of floats.")
        if any(
            (not isinstance(x, (int, float))) or not np.isfinite(float(x)) for x in v
        ):
            raise ValueError(f"Non-finite numeric in '{k}'.")
        lens.append(len(v))
    if len(set(lens)) != 1:
        raise ValueError(f"All lists must have the same length, got {lens}")

    x = list(range(lens[0]))
    map_series = [m["map_50"] for m in losses["mAP"]]

    fig, axes = plt.subplots(2, 2, figsize=figsize, constrained_layout=True)
    panels = [
        ("Total loss", [("train", losses["train_loss"]), ("validation", losses["test_loss"])], "loss"),
        ("mAP", [("mAP", map_series)], "mAP"),
        ("Classification loss", [("train", losses["train_loss_conf"]), ("validation", losses["test_loss_conf"])], "loss"),
        ("Localization loss", [("train", losses["train_loss_loc"]), ("validation", losses["test_loss_loc"])], "loss"),
    ]
    for ax, (title, series, ylabel) in zip(axes.flat, panels):
        for name, ys in series:
            ax.plot(x, ys, label=name)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.grid(True, linestyle="--", linewidth=0.5, alpha=0.6)
        ax.legend()
    return fig
