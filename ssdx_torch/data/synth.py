"""SynthDrive: synthetic driving-scene dataset generator.

The Udacity self-driving-car dataset the reference trains on
(reference README.md "Dataset", SSD_model_train.ipynb) is not available in
this offline environment, so this module synthesizes a stand-in posing the
same *shape* of learning problem:

* the reference's 5 road-user classes (``biker, car, pedestrian,
  trafficLight, truck``) with Udacity-like class imbalance (cars dominate),
* strong scale variation tied to scene depth (perspective: object height
  shrinks toward the horizon) — exercising all six SSD feature-map scales,
* occlusion (objects drawn far-to-near may cover each other; ground truth
  keeps objects down to 25% visibility, like real-world labels),
* background clutter that must be *rejected* (unlabeled buildings, trees,
  lane markings, road texture) so the background class is non-trivial,
* a minority of ``'empty'`` frames, annotated with the reference CSV's
  ``class='empty'`` convention (dataset.py handles these as background).

Annotations are written in the reference's CSV format
(``filename,width,height,class,xmin,ymin,xmax,ymax`` — CarImageClass.py's
scan contract), so the entire stack — directory scan, stratified split,
bootstrap loader, augmentation, training, eval, serving — runs on it
unmodified.  The port's own copy of ``ssdx/data/synth.py`` (numpy, cv2 and,
for the CSV, pandas).

This is deliberately a *renderer*, not noise: each class has a distinct
shape+color signature a detector must localize, at sizes from ~10 px
(near-horizon pedestrians) to ~300 px (close trucks).
"""
from __future__ import annotations

import pathlib

import numpy as np

__all__ = ["CLASSES", "generate_dataset", "render_scene"]

# Matches the serving map (ssdx_torch/serve/app.py CLASS_TO_IDX) and the
# reference's Udacity label set.
CLASSES = ("biker", "car", "pedestrian", "trafficLight", "truck")
_CLASS_P = (0.12, 0.45, 0.18, 0.10, 0.15)  # Udacity-like imbalance
# Near-field (bottom-of-frame) object heights as a fraction of image height.
_NEAR_H = {"car": 0.28, "truck": 0.42, "pedestrian": 0.30, "biker": 0.32,
           "trafficLight": 0.22}
_MIN_VISIBLE = 0.25  # GT kept while >= this fraction of its pixels show
_MIN_SIDE_PX = 8


def _hsv(rng, h_lo, h_hi, s_lo=140, s_hi=255, v_lo=120, v_hi=255):
    import cv2

    h = rng.integers(h_lo, h_hi + 1) % 180
    hsv = np.uint8([[[h, rng.integers(s_lo, s_hi), rng.integers(v_lo, v_hi)]]])
    return tuple(int(c) for c in cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)[0, 0])


def _paint(img, id_map, idx, mask, color):
    """Paint ``color`` where ``mask`` and record ownership in ``id_map``."""
    img[mask] = color
    id_map[mask] = idx


def _shape_mask(shape, draw):
    import cv2  # noqa: F401  (draw closures use cv2)

    m = np.zeros(shape[:2], np.uint8)
    draw(m)
    return m.astype(bool)


def _draw_car(img, id_map, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(1.7, 2.1))
    x0, y0 = int(cx - w / 2), int(yb - h)
    body = _hsv(rng, 0, 179, 60, 255, 60, 230)
    m = _shape_mask(img.shape, lambda a: (
        cv2.rectangle(a, (x0, y0 + int(0.35 * h)), (x0 + w, y0 + h), 1, -1),
        cv2.rectangle(a, (x0 + int(0.2 * w), y0), (x0 + int(0.8 * w), y0 + int(0.45 * h)), 1, -1),
    ))
    _paint(img, id_map, idx, m, body)
    # windows + wheels paint over the body but belong to the same instance
    win = _shape_mask(img.shape, lambda a: cv2.rectangle(
        a, (x0 + int(0.26 * w), y0 + int(0.08 * h)),
        (x0 + int(0.74 * w), y0 + int(0.38 * h)), 1, -1))
    _paint(img, id_map, idx, win, (40, 48, 60))
    r = max(2, int(0.14 * h))
    for wx in (x0 + int(0.22 * w), x0 + int(0.78 * w)):
        wm = _shape_mask(img.shape, lambda a: cv2.circle(a, (wx, y0 + h), r, 1, -1))
        _paint(img, id_map, idx, wm, (15, 15, 18))
    return x0, y0, x0 + w, int(yb + r * 0.6)


def _draw_truck(img, id_map, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(2.0, 2.6))
    x0, y0 = int(cx - w / 2), int(yb - h)
    box_col = _hsv(rng, 0, 179, 10, 120, 120, 245)  # washed-out trailer
    cab_col = _hsv(rng, 0, 179, 80, 255, 60, 220)
    m = _shape_mask(img.shape, lambda a: cv2.rectangle(
        a, (x0, y0), (x0 + int(0.72 * w), y0 + h), 1, -1))
    _paint(img, id_map, idx, m, box_col)
    cab = _shape_mask(img.shape, lambda a: cv2.rectangle(
        a, (x0 + int(0.72 * w), y0 + int(0.35 * h)), (x0 + w, y0 + h), 1, -1))
    _paint(img, id_map, idx, cab, cab_col)
    r = max(2, int(0.10 * h))
    for wx in (x0 + int(0.15 * w), x0 + int(0.55 * w), x0 + int(0.86 * w)):
        wm = _shape_mask(img.shape, lambda a: cv2.circle(a, (wx, y0 + h), r, 1, -1))
        _paint(img, id_map, idx, wm, (15, 15, 18))
    return x0, y0, x0 + w, int(yb + r * 0.6)


def _draw_pedestrian(img, id_map, idx, rng, cx, yb, h):
    import cv2

    w = max(3, int(h * 0.34))
    x0, y0 = int(cx - w / 2), int(yb - h)
    shirt = _hsv(rng, 0, 179, 100, 255, 80, 230)
    pants = _hsv(rng, 100, 140, 60, 200, 30, 120)
    skin = (int(rng.integers(170, 230)), int(rng.integers(130, 185)), int(rng.integers(100, 150)))
    rh = max(1, int(0.13 * h))
    head = _shape_mask(img.shape, lambda a: cv2.circle(
        a, (int(cx), y0 + rh), rh, 1, -1))
    _paint(img, id_map, idx, head, tuple(int(c) for c in skin))
    torso = _shape_mask(img.shape, lambda a: cv2.rectangle(
        a, (x0, y0 + int(0.24 * h)), (x0 + w, y0 + int(0.58 * h)), 1, -1))
    _paint(img, id_map, idx, torso, shirt)
    legs = _shape_mask(img.shape, lambda a: (
        cv2.rectangle(a, (x0 + 1, y0 + int(0.58 * h)),
                      (int(cx) - 1, y0 + h), 1, -1),
        cv2.rectangle(a, (int(cx) + 1, y0 + int(0.58 * h)),
                      (x0 + w - 1, y0 + h), 1, -1),
    ))
    _paint(img, id_map, idx, legs, pants)
    return x0, y0, x0 + w, int(yb)


def _draw_biker(img, id_map, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(0.8, 1.0))
    x0 = int(cx - w / 2)
    r = max(2, int(0.24 * h))
    frame = _hsv(rng, 0, 179, 120, 255, 90, 230)
    wy = int(yb - r)
    m = _shape_mask(img.shape, lambda a: (
        cv2.circle(a, (x0 + r, wy), r, 1, 2),
        cv2.circle(a, (x0 + w - r, wy), r, 1, 2),
        cv2.line(a, (x0 + r, wy), (x0 + w - r, wy), 1, 2),
        cv2.line(a, (x0 + r, wy), (int(cx), int(yb - 0.55 * h)), 1, 2),
    ))
    _paint(img, id_map, idx, m, frame)
    # rider: torso + head leaning over the frame
    _draw_pedestrian(img, id_map, idx, rng, cx, int(yb - 0.40 * h),
                     max(4, int(0.55 * h)))
    return x0, int(yb - h), x0 + w, int(yb)


def _draw_trafficlight(img, id_map, idx, rng, cx, yb, h):
    import cv2

    w = max(4, int(h * 0.40))
    x0, y0 = int(cx - w / 2), int(yb - h)
    # pole below the housing: scenery, not part of the labeled box
    import cv2 as _cv

    _cv.line(img, (int(cx), int(yb)), (int(cx), int(yb + 2.2 * h)),
             (70, 70, 74), max(1, w // 5))
    house = _shape_mask(img.shape, lambda a: cv2.rectangle(
        a, (x0, y0), (x0 + w, y0 + h), 1, -1))
    _paint(img, id_map, idx, house, (35, 38, 42))
    lit = rng.integers(0, 3)
    lamps = ((235, 40, 40), (235, 200, 40), (40, 220, 70))
    r = max(1, int(0.13 * h))
    for i, col in enumerate(lamps):
        c = col if i == lit else tuple(int(x * 0.3) for x in col)
        lm = _shape_mask(img.shape, lambda a: cv2.circle(
            a, (int(cx), y0 + int((0.2 + 0.3 * i) * h)), r, 1, -1))
        _paint(img, id_map, idx, lm, c)
    return x0, y0, x0 + w, int(yb)


_RENDER = {"car": _draw_car, "truck": _draw_truck,
           "pedestrian": _draw_pedestrian, "biker": _draw_biker,
           "trafficLight": _draw_trafficlight}


def _background(rng, size):
    import cv2

    H = W = size
    img = np.zeros((H, W, 3), np.uint8)
    horizon = int(rng.uniform(0.28, 0.45) * H)
    # sky: vertical gradient between two bright tints
    top = np.array(_hsv(rng, 90, 130, 20, 110, 170, 255), np.float32)
    bot = np.array(_hsv(rng, 10, 40, 10, 90, 150, 245), np.float32)
    t = (np.arange(horizon, dtype=np.float32) / max(horizon - 1, 1))[:, None, None]
    img[:horizon] = (top * (1 - t) + bot * t).astype(np.uint8)
    # ground
    g = int(rng.integers(95, 135))
    img[horizon:] = (g, int(g * 0.95), int(g * 0.85))
    # buildings / trees above the horizon (unlabeled clutter)
    for _ in range(rng.integers(3, 9)):
        w = rng.integers(W // 16, W // 4)
        h = rng.integers(H // 16, horizon)
        x = rng.integers(0, W - w)
        if rng.random() < 0.5:
            cv2.rectangle(img, (x, horizon - h), (x + w, horizon),
                          _hsv(rng, 0, 30, 10, 80, 60, 180), -1)
        else:
            cv2.ellipse(img, (x + w // 2, horizon - h // 3), (w // 2, h // 2),
                        0, 0, 360, _hsv(rng, 35, 75, 80, 220, 40, 160), -1)
    # road: trapezoid from the bottom edge to a vanishing point
    vx = int(W * rng.uniform(0.35, 0.65))
    half_bot = int(W * rng.uniform(0.30, 0.48))
    road = np.array([[W // 2 - half_bot, H], [W // 2 + half_bot, H],
                     [vx + W // 24, horizon], [vx - W // 24, horizon]], np.int32)
    shade = int(rng.integers(55, 80))
    cv2.fillPoly(img, [road], (shade, shade, shade + 4))
    # dashed center line
    for i in range(6):
        f0, f1 = (i + 0.15) / 6, (i + 0.5) / 6
        p0 = (int(vx + (W // 2 - vx) * f0), int(horizon + (H - horizon) * f0))
        p1 = (int(vx + (W // 2 - vx) * f1), int(horizon + (H - horizon) * f1))
        cv2.line(img, p0, p1, (225, 220, 180), max(1, int(1 + 4 * f0)))
    return img, horizon, vx


def render_scene(rng, size: int = 512, n_objects: int | None = None):
    """Render one scene; returns (image uint8 RGB HWC, boxes xyxy float32
    [n,4], labels int64 [n] indexing into CLASSES)."""
    img, horizon, vx = _background(rng, size)
    id_map = np.full((size, size), -1, np.int32)
    if n_objects is None:
        n_objects = int(rng.integers(1, 7))
    # far-to-near draw order so nearer objects occlude farther ones
    depths = np.sort(rng.uniform(0.08, 1.0, n_objects))
    entries = []
    for i, t in enumerate(depths):
        cls = str(rng.choice(CLASSES, p=_CLASS_P))
        yb = horizon + t * (size - horizon) * rng.uniform(0.92, 1.0)
        if cls == "trafficLight":
            # lights hang higher: bottom well above the ground line
            yb -= (size - horizon) * t * rng.uniform(0.45, 0.75)
        h = _NEAR_H[cls] * size * (0.12 + 0.88 * t) * rng.uniform(0.8, 1.2)
        if h < 6:
            continue
        # lateral placement: vehicles near the road center line, others wider
        spread = 0.42 if cls in ("car", "truck") else 0.6
        road_cx = vx + (size / 2 - vx) * t
        cx = road_cx + rng.uniform(-spread, spread) * size * (0.25 + 0.75 * t)
        box = _RENDER[cls](img, id_map, i, rng, cx, int(yb), int(h))
        area = max(0, (min(box[2], size) - max(box[0], 0))) * \
            max(0, (min(box[3], size) - max(box[1], 0)))
        entries.append((i, cls, box, (id_map == i).sum(), area))
    boxes, labels = [], []
    for i, cls, (x0, y0, x1, y1), painted, _ in entries:
        x0c, y0c = max(x0, 0), max(y0, 0)
        x1c, y1c = min(x1, size), min(y1, size)
        if x1c - x0c < _MIN_SIDE_PX or y1c - y0c < _MIN_SIDE_PX or painted == 0:
            continue
        visible = (id_map[y0c:y1c, x0c:x1c] == i).sum()
        if visible / painted < _MIN_VISIBLE:
            continue  # occluded beyond labeling, like real GT policy
        boxes.append((x0c, y0c, x1c, y1c))
        labels.append(CLASSES.index(cls))
    # sensor noise + slight blur so edges aren't single-pixel-perfect
    import cv2

    img = cv2.GaussianBlur(img, (3, 3), 0)
    noise = rng.normal(0, 6, img.shape)
    img = np.clip(img.astype(np.int16) + noise.astype(np.int16), 0, 255).astype(np.uint8)
    return (img, np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64))


def generate_dataset(root: str | pathlib.Path, n_images: int, seed: int = 0,
                     size: int = 512, empty_frac: float = 0.05) -> "object":
    """Write ``n_images`` scenes + the reference-format annotation CSV under
    ``root``; returns the annotation DataFrame."""
    import cv2
    import pandas as pd

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n_images):
        name = f"synth_{seed}_{k:05d}.jpg"
        n_obj = 0 if rng.random() < empty_frac else None
        for _ in range(4):  # non-empty scenes must keep >= 1 visible box
            img, boxes, labels = render_scene(rng, size=size, n_objects=n_obj)
            if n_obj == 0 or len(boxes):
                break
        cv2.imwrite(str(root / name), img[:, :, ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        if len(boxes) == 0:
            rows.append(dict(filename=name, width=size, height=size,
                             **{"class": "empty"}, xmin=0, ymin=0, xmax=0, ymax=0))
        for b, l in zip(boxes, labels):
            rows.append(dict(filename=name, width=size, height=size,
                             **{"class": CLASSES[int(l)]},
                             xmin=int(b[0]), ymin=int(b[1]),
                             xmax=int(b[2]), ymax=int(b[3])))
    df = pd.DataFrame(rows)
    df.to_csv(root / "annotations.csv", index=False)
    return df


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=640)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    df = generate_dataset(args.out, args.n, seed=args.seed, size=args.size)
    by = df[df["class"] != "empty"]["class"].value_counts()
    print(f"wrote {args.n} images, {len(by)} classes:\n{by}")


if __name__ == "__main__":
    main()
