"""Street scenes for the benchmark's inputs, drawn from a seed.

A frozen copy of the SynthDrive renderer that the demo bundle was trained
on (five road-user classes with a Udacity-like imbalance, perspective
scale, occlusion, unlabeled clutter, sensor noise), kept here so that no
change to the program can move the benchmark's inputs.  Scene ``i`` of a
seed is drawn from ``numpy.random.default_rng([seed, stream, i])``, so a
scene does not depend on how many others are drawn or on which process
draws it.  Rendering runs on a few threads.

Also here: what the cells make of scenes.  ``serve_images`` resizes to
300x300 with area averaging and normalizes with the ImageNet statistics
(float32 NHWC, the API's input); ``train_batches`` adds ground truth padded
to ``MAX_OBJECTS`` boxes.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

CLASSES = ("biker", "car", "pedestrian", "trafficLight", "truck")
MAX_OBJECTS = 6  # render_scene draws 1..6 objects
_CLASS_P = (0.12, 0.45, 0.18, 0.10, 0.15)
_NEAR_H = {"car": 0.28, "truck": 0.42, "pedestrian": 0.30, "biker": 0.32, "trafficLight": 0.22}
_MIN_VISIBLE = 0.25
_MIN_SIDE_PX = 8
MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _color(rng, h_lo, h_hi, s_lo=140, s_hi=255, v_lo=120, v_hi=255):
    import cv2

    h = rng.integers(h_lo, h_hi + 1) % 180
    hsv = np.uint8([[[h, rng.integers(s_lo, s_hi), rng.integers(v_lo, v_hi)]]])
    return tuple(int(c) for c in cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)[0, 0])


class _Canvas:
    """An image and the instance id owning each pixel."""

    def __init__(self, img):
        self.img = img
        self.owner = np.full(img.shape[:2], -1, np.int32)

    def fill(self, idx, color, *shapes):
        """Paint the union of ``shapes`` (callables drawing 1s into a mask)."""
        m = np.zeros(self.img.shape[:2], np.uint8)
        for draw in shapes:
            draw(m)
        m = m.astype(bool)
        self.img[m] = color
        self.owner[m] = idx


def _car(cv, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(1.7, 2.1))
    x0, y0 = int(cx - w / 2), int(yb - h)
    cv.fill(idx, _color(rng, 0, 179, 60, 255, 60, 230),
            lambda a: cv2.rectangle(a, (x0, y0 + int(0.35 * h)), (x0 + w, y0 + h), 1, -1),
            lambda a: cv2.rectangle(a, (x0 + int(0.2 * w), y0),
                                    (x0 + int(0.8 * w), y0 + int(0.45 * h)), 1, -1))
    cv.fill(idx, (40, 48, 60), lambda a: cv2.rectangle(
        a, (x0 + int(0.26 * w), y0 + int(0.08 * h)), (x0 + int(0.74 * w), y0 + int(0.38 * h)),
        1, -1))
    r = max(2, int(0.14 * h))
    for wx in (x0 + int(0.22 * w), x0 + int(0.78 * w)):
        cv.fill(idx, (15, 15, 18), lambda a, wx=wx: cv2.circle(a, (wx, y0 + h), r, 1, -1))
    return x0, y0, x0 + w, int(yb + r * 0.6)


def _truck(cv, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(2.0, 2.6))
    x0, y0 = int(cx - w / 2), int(yb - h)
    box_col = _color(rng, 0, 179, 10, 120, 120, 245)
    cab_col = _color(rng, 0, 179, 80, 255, 60, 220)
    cv.fill(idx, box_col, lambda a: cv2.rectangle(a, (x0, y0), (x0 + int(0.72 * w), y0 + h), 1, -1))
    cv.fill(idx, cab_col, lambda a: cv2.rectangle(
        a, (x0 + int(0.72 * w), y0 + int(0.35 * h)), (x0 + w, y0 + h), 1, -1))
    r = max(2, int(0.10 * h))
    for wx in (x0 + int(0.15 * w), x0 + int(0.55 * w), x0 + int(0.86 * w)):
        cv.fill(idx, (15, 15, 18), lambda a, wx=wx: cv2.circle(a, (wx, y0 + h), r, 1, -1))
    return x0, y0, x0 + w, int(yb + r * 0.6)


def _pedestrian(cv, idx, rng, cx, yb, h):
    import cv2

    w = max(3, int(h * 0.34))
    x0, y0 = int(cx - w / 2), int(yb - h)
    shirt = _color(rng, 0, 179, 100, 255, 80, 230)
    pants = _color(rng, 100, 140, 60, 200, 30, 120)
    skin = (int(rng.integers(170, 230)), int(rng.integers(130, 185)), int(rng.integers(100, 150)))
    rh = max(1, int(0.13 * h))
    cv.fill(idx, skin, lambda a: cv2.circle(a, (int(cx), y0 + rh), rh, 1, -1))
    cv.fill(idx, shirt, lambda a: cv2.rectangle(
        a, (x0, y0 + int(0.24 * h)), (x0 + w, y0 + int(0.58 * h)), 1, -1))
    cv.fill(idx, pants,
            lambda a: cv2.rectangle(a, (x0 + 1, y0 + int(0.58 * h)), (int(cx) - 1, y0 + h), 1, -1),
            lambda a: cv2.rectangle(a, (int(cx) + 1, y0 + int(0.58 * h)),
                                    (x0 + w - 1, y0 + h), 1, -1))
    return x0, y0, x0 + w, int(yb)


def _biker(cv, idx, rng, cx, yb, h):
    import cv2

    w = int(h * rng.uniform(0.8, 1.0))
    x0 = int(cx - w / 2)
    r = max(2, int(0.24 * h))
    wy = int(yb - r)
    cv.fill(idx, _color(rng, 0, 179, 120, 255, 90, 230),
            lambda a: cv2.circle(a, (x0 + r, wy), r, 1, 2),
            lambda a: cv2.circle(a, (x0 + w - r, wy), r, 1, 2),
            lambda a: cv2.line(a, (x0 + r, wy), (x0 + w - r, wy), 1, 2),
            lambda a: cv2.line(a, (x0 + r, wy), (int(cx), int(yb - 0.55 * h)), 1, 2))
    _pedestrian(cv, idx, rng, cx, int(yb - 0.40 * h), max(4, int(0.55 * h)))
    return x0, int(yb - h), x0 + w, int(yb)


def _traffic_light(cv, idx, rng, cx, yb, h):
    import cv2

    w = max(4, int(h * 0.40))
    x0, y0 = int(cx - w / 2), int(yb - h)
    cv2.line(cv.img, (int(cx), int(yb)), (int(cx), int(yb + 2.2 * h)), (70, 70, 74),
             max(1, w // 5))  # the pole is scenery, outside the box
    cv.fill(idx, (35, 38, 42), lambda a: cv2.rectangle(a, (x0, y0), (x0 + w, y0 + h), 1, -1))
    lit = rng.integers(0, 3)
    r = max(1, int(0.13 * h))
    for i, col in enumerate(((235, 40, 40), (235, 200, 40), (40, 220, 70))):
        c = col if i == lit else tuple(int(x * 0.3) for x in col)
        cv.fill(idx, c, lambda a, i=i: cv2.circle(
            a, (int(cx), y0 + int((0.2 + 0.3 * i) * h)), r, 1, -1))
    return x0, y0, x0 + w, int(yb)


_DRAW = {"car": _car, "truck": _truck, "pedestrian": _pedestrian, "biker": _biker,
         "trafficLight": _traffic_light}


def _background(rng, size):
    import cv2

    img = np.zeros((size, size, 3), np.uint8)
    horizon = int(rng.uniform(0.28, 0.45) * size)
    top = np.array(_color(rng, 90, 130, 20, 110, 170, 255), np.float32)
    bot = np.array(_color(rng, 10, 40, 10, 90, 150, 245), np.float32)
    t = (np.arange(horizon, dtype=np.float32) / max(horizon - 1, 1))[:, None, None]
    img[:horizon] = (top * (1 - t) + bot * t).astype(np.uint8)
    g = int(rng.integers(95, 135))
    img[horizon:] = (g, int(g * 0.95), int(g * 0.85))
    for _ in range(rng.integers(3, 9)):  # buildings and trees: unlabeled clutter
        w = rng.integers(size // 16, size // 4)
        h = rng.integers(size // 16, horizon)
        x = rng.integers(0, size - w)
        if rng.random() < 0.5:
            cv2.rectangle(img, (x, horizon - h), (x + w, horizon),
                          _color(rng, 0, 30, 10, 80, 60, 180), -1)
        else:
            cv2.ellipse(img, (x + w // 2, horizon - h // 3), (w // 2, h // 2), 0, 0, 360,
                        _color(rng, 35, 75, 80, 220, 40, 160), -1)
    vx = int(size * rng.uniform(0.35, 0.65))
    half_bot = int(size * rng.uniform(0.30, 0.48))
    road = np.array([[size // 2 - half_bot, size], [size // 2 + half_bot, size],
                     [vx + size // 24, horizon], [vx - size // 24, horizon]], np.int32)
    shade = int(rng.integers(55, 80))
    cv2.fillPoly(img, [road], (shade, shade, shade + 4))
    for i in range(6):  # dashed center line
        f0, f1 = (i + 0.15) / 6, (i + 0.5) / 6
        p0 = (int(vx + (size // 2 - vx) * f0), int(horizon + (size - horizon) * f0))
        p1 = (int(vx + (size // 2 - vx) * f1), int(horizon + (size - horizon) * f1))
        cv2.line(img, p0, p1, (225, 220, 180), max(1, int(1 + 4 * f0)))
    return img, horizon, vx


def render_scene(rng, size: int = 512):
    """One scene: (image uint8 RGB [size,size,3], boxes xyxy pixels float32
    [n,4], labels int64 [n] into ``CLASSES``), 1 to ``MAX_OBJECTS`` objects."""
    import cv2

    img, horizon, vx = _background(rng, size)
    cv = _Canvas(img)
    n_objects = int(rng.integers(1, MAX_OBJECTS + 1))
    placed = []
    for i, t in enumerate(np.sort(rng.uniform(0.08, 1.0, n_objects))):  # far to near
        cls = str(rng.choice(CLASSES, p=_CLASS_P))
        yb = horizon + t * (size - horizon) * rng.uniform(0.92, 1.0)
        if cls == "trafficLight":
            yb -= (size - horizon) * t * rng.uniform(0.45, 0.75)
        h = _NEAR_H[cls] * size * (0.12 + 0.88 * t) * rng.uniform(0.8, 1.2)
        if h < 6:
            continue
        spread = 0.42 if cls in ("car", "truck") else 0.6
        road_cx = vx + (size / 2 - vx) * t
        cx = road_cx + rng.uniform(-spread, spread) * size * (0.25 + 0.75 * t)
        box = _DRAW[cls](cv, i, rng, cx, int(yb), int(h))
        placed.append((i, cls, box, (cv.owner == i).sum()))
    boxes, labels = [], []
    for i, cls, (x0, y0, x1, y1), painted in placed:
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, size), min(y1, size)
        if x1 - x0 < _MIN_SIDE_PX or y1 - y0 < _MIN_SIDE_PX or painted == 0:
            continue
        if (cv.owner[y0:y1, x0:x1] == i).sum() / painted < _MIN_VISIBLE:
            continue  # occluded beyond labeling
        boxes.append((x0, y0, x1, y1))
        labels.append(CLASSES.index(cls))
    img = cv2.GaussianBlur(cv.img, (3, 3), 0)
    noise = rng.normal(0, 6, img.shape)
    img = np.clip(img.astype(np.int16) + noise.astype(np.int16), 0, 255).astype(np.uint8)
    return img, np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(labels, np.int64)


def _render_one(args):
    import cv2

    cv2.setNumThreads(1)
    seed, stream, i, size = args
    return render_scene(np.random.default_rng([seed, stream, i]), size)


class Pending:
    """Scenes being rendered; ``get`` waits for them, one list per stream."""

    def __init__(self, pool, futures, sizes):
        self.pool, self.futures, self.sizes = pool, futures, sizes

    def get(self) -> list:
        try:
            flat = [f.result() for f in self.futures]
        finally:
            self.pool.shutdown()
        out, k = [], 0
        for n in self.sizes:
            out.append(flat[k:k + n])
            k += n
        return out


def render_async(seed: int, streams, size: int = 512, workers: int = 4) -> Pending:
    """Start rendering scenes ``0..n-1`` of each ``(stream, n)`` of ``seed`` on
    ``workers`` threads (OpenCV's drawing releases the interpreter lock);
    the scenes do not depend on ``workers``."""
    pool = ThreadPoolExecutor(max(1, workers))
    futures = [pool.submit(_render_one, (seed, stream, i, size))
               for stream, n in streams for i in range(n)]
    return Pending(pool, futures, [n for _, n in streams])


def render_many(seed: int, stream: int, n: int, size: int = 512, workers: int = 4) -> list:
    """Scenes ``0..n-1`` of ``(seed, stream)``."""
    return render_async(seed, [(stream, n)], size, workers).get()[0]


def to_input(img: np.ndarray, out: int = 300) -> np.ndarray:
    """uint8 RGB -> float32 [out,out,3], area-averaged and ImageNet-normalized."""
    import cv2

    small = cv2.resize(img, (out, out), interpolation=cv2.INTER_AREA)
    return (small.astype(np.float32) / 255.0 - MEAN) / STD


def serve_images(scenes, out: int = 300) -> np.ndarray:
    """[N,out,out,3] float32 of the scenes' images."""
    return np.stack([to_input(img, out) for img, _, _ in scenes])


def train_batches(scenes, batch: int, out: int = 300) -> list[dict]:
    """Consecutive batches of ``batch`` scenes with ground truth padded to
    ``MAX_OBJECTS``: images [B,out,out,3] float32, boxes [B,G,4] xyxy in
    [0,1], labels [B,G] int32, valid [B,G] bool."""
    out_batches = []
    for s in range(0, len(scenes) - batch + 1, batch):
        chunk = scenes[s:s + batch]
        boxes = np.zeros((batch, MAX_OBJECTS, 4), np.float32)
        labels = np.zeros((batch, MAX_OBJECTS), np.int32)
        valid = np.zeros((batch, MAX_OBJECTS), bool)
        for b, (img, bx, lb) in enumerate(chunk):
            n = len(bx)
            boxes[b, :n] = bx / img.shape[0]
            labels[b, :n] = lb
            valid[b, :n] = True
        out_batches.append({"images": serve_images(chunk, out), "boxes": boxes,
                            "labels": labels, "valid": valid})
    return out_batches
