"""Side-by-side prediction panel: the demo app's render path.

The port's own copy of ``side_by_side_prediction`` from ``ssdx/viz.py``
(PIL only): EXIF fix, predict at 300x300, resize the original to
``target_height`` preserving aspect (LANCZOS), draw red boxes with
white-on-red class chips, and concatenate original | annotated.
"""
from __future__ import annotations

from .model import IMAGE_SIZE

__all__ = ["side_by_side_prediction"]


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
