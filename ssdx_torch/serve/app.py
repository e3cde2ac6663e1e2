"""HTTP demo app of the PyTorch port: browser upload -> side-by-side PNG.

Same routes and contract as ``ssdx/serve/app.py``: ``GET /`` upload page,
``GET /model-card``, ``GET /examples``, ``GET /static/*``, ``GET /healthz``
and ``POST /predict`` (multipart or raw image -> PNG), listening on
``$PORT`` (default 8080).  Built on the stdlib ``http.server`` (threaded).

Run it with ``python -m ssdx_torch.serve.app``.  On the GPU the detector
runs the BN-folded bf16 network with the stem and NMS kernels; with
``SSDX_INT8=1`` in the environment the post-stem backbone is quantized to
int8 and runs through the int8 conv kernels.  Without
``saved_models/best.weights`` it serves a demo bundle: the port's own,
``ssdx_torch/serve/demo_weights.npz``, when ``python -m
ssdx_torch.tools.make_demo_weights`` has written it, else the JAX package's,
read by path from ``ssdx/serve/demo_weights.npz``; the example scenes come
from ``ssdx/serve/static``.
"""
from __future__ import annotations

import email
import email.policy
import io
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from .. import resolve_device

__all__ = ["CLASS_TO_IDX", "serving_weights", "create_detector", "create_server", "main"]

# Deployment class map of the demo model
CLASS_TO_IDX = {"biker": 0, "car": 1, "pedestrian": 2, "trafficLight": 3, "truck": 4}

DEFAULT_WEIGHTS = "saved_models/best.weights"
_SSDX_SERVE = Path(__file__).resolve().parents[2] / "ssdx" / "serve"
BUNDLED_WEIGHTS = _SSDX_SERVE / "demo_weights.npz"  # the JAX package's bundle
PORT_BUNDLE = Path(__file__).resolve().parent / "demo_weights.npz"  # never committed
STATIC_DIR = _SSDX_SERVE / "static"

_INDEX_HTML = """<!doctype html>
<html><head><title>SSDX — SSD300 demo (PyTorch/CUDA)</title>
<style>
 body { font-family: sans-serif; max-width: 900px; margin: 2rem auto; }
 .panel { border: 1px solid #ccc; border-radius: 8px; padding: 1rem; }
 img { max-width: 100%; }
 nav a { margin-right: 1rem; }
</style></head>
<body>
<nav><a href="/">Home</a><a href="/model-card">Model card</a>
<a href="/examples">Examples</a></nav>
<h1>SSD300 object detection</h1>
<p>Upload a street-scene image; the detector returns the original and the
annotated image side by side.</p>
<div class="panel">
  <input type="file" id="file" accept="image/*">
  <button onclick="run()">Detect</button>
  <p id="status"></p>
  <img id="result">
</div>
<script>
async function run() {
  const f = document.getElementById('file').files[0];
  if (!f) { document.getElementById('status').textContent = 'pick a file first'; return; }
  const fd = new FormData();
  fd.append('file', f);
  document.getElementById('status').textContent = 'running…';
  const r = await fetch('/predict', { method: 'POST', body: fd });
  if (!r.ok) { document.getElementById('status').textContent = 'error ' + r.status; return; }
  const blob = await r.blob();
  document.getElementById('result').src = URL.createObjectURL(blob);
  document.getElementById('status').textContent = 'done';
}
</script>
</body></html>"""

_MODEL_CARD_HTML = """<!doctype html>
<html><head><title>Model card — SSDX</title>
<style>
 body { font-family: sans-serif; max-width: 900px; margin: 2rem auto; }
 nav a { margin-right: 1rem; }
</style></head>
<body>
<nav><a href="/">Home</a><a href="/model-card">Model card</a>
<a href="/examples">Examples</a></nav>
<h1>Model card</h1>
<ul>
<li><b>Architecture:</b> SSD300 — VGG16+BatchNorm backbone, 6 multibox
feature heads, 8732 priors (~26M params).</li>
<li><b>Framework:</b> ssdx_torch (PyTorch; hand-written CUDA kernels for the
fused conv1 stem and the batched DIoU-NMS on NVIDIA Hopper); serving runs
the BN-folded weights in bfloat16 on the GPU.</li>
<li><b>Classes:</b> biker, car, pedestrian, trafficLight, truck.</li>
<li><b>Thresholds:</b> score 0.2, NMS (DIoU) 0.3, max 100 detections.</li>
</ul>
<p>Throughput and kernel times on the GPU are recorded in the repository's
<code>PERF.md</code> (measured by <code>chip_smoke.py</code>).</p>
</body></html>"""


def serving_weights(weights_path: str | os.PathLike | None = None) -> Path | None:
    """The weights the app serves: ``weights_path`` (default
    ``DEFAULT_WEIGHTS``) when it exists, else the port's demo bundle, else
    the JAX package's; None when there are none."""
    for path in (Path(weights_path or DEFAULT_WEIGHTS), PORT_BUNDLE, BUNDLED_WEIGHTS):
        if path.exists():
            return path
    return None


def create_detector(weights_path: str | os.PathLike | None = None, device=None,
                    width_mult: float = 1.0):
    """Build the serving Detector, loading exported weights when present
    (:func:`serving_weights` picks them; ``det.weights_source`` names them).

    ``device`` defaults to ``cuda`` (and raises without a GPU).  On the GPU
    the network runs BN-folded in bfloat16 with the fused stem kernel; on
    the CPU it runs the plain float32 path.

    ``SSDX_INT8=1`` also quantizes the post-stem backbone to int8
    (``ssdx_torch/quant.py``), calibrated on the bundled example scenes;
    prefer calibrating on production traffic through
    ``Detector.quantize_int8`` and passing the detector in.  On the GPU the
    int8 convs run through the kernels of ``ssdx_torch/ops/int8_conv.py``,
    on the CPU through ``quant.apply_int8``.
    """
    from ..api import Detector

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    kw = dict(device=dev, stem_kernel=on_gpu, width_mult=width_mult,
              dtype=torch.bfloat16 if on_gpu else torch.float32)
    path = serving_weights(weights_path)
    if path is not None:
        det = Detector.from_weights(path, CLASS_TO_IDX, **kw)
        det.weights_loaded = True
        det.demo_weights = path in (PORT_BUNDLE, BUNDLED_WEIGHTS)
    else:
        det = Detector(CLASS_TO_IDX, fold_bn=on_gpu, **kw)
        # random-init weights draw noise boxes: the server says so
        det.weights_loaded = False
        det.demo_weights = False
    det.weights_source = path
    if os.environ.get("SSDX_INT8") == "1" and det.fold_bn:
        import numpy as np
        from PIL import Image

        calib = np.concatenate([det.preprocess_pil(Image.open(p))
                                for p in sorted(STATIC_DIR.glob("example_*.jpg"))])
        det.quantize_int8(calib)
        det.int8 = True
    return det


def _parse_multipart(headers, body: bytes) -> bytes | None:
    """Extract the first file part from a multipart/form-data body."""
    ctype = headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype:
        return None
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body,
        policy=email.policy.default,
    )
    for part in msg.iter_parts():
        if part.get_filename() or part.get_param("name", header="content-disposition") == "file":
            return part.get_payload(decode=True)
    return None


def create_server(
    detector=None,
    host: str = "0.0.0.0",
    port: int | None = None,
    static_dir: str | os.PathLike | None = None,
    score_thresh: float = 0.2,
    nms_thresh: float = 0.3,
    max_per_img: int = 100,
    target_height: int = 512,
    batching: bool = True,
    max_batch: int = 8,
    max_wait_ms: float = 4.0,
    batching_warmup: bool | None = None,
) -> ThreadingHTTPServer:
    """Build (but don't start) the threaded HTTP server.

    ``batching=True`` (default) routes predictions through a
    :class:`ssdx_torch.serve.batcher.MicroBatcher`, so concurrent uploads
    share one batched device dispatch.  ``batching_warmup`` (default: on
    the GPU) runs each batch bucket once at start-up.
    """
    from PIL import Image

    from ..viz import side_by_side_prediction

    if detector is None:
        detector = create_detector()
    if port is None:
        port = int(os.environ.get("PORT", "8080"))
    if not getattr(detector, "weights_loaded", True):
        banner = (
            "<div style='background:#c0392b;color:#fff;padding:0.6rem 1rem;"
            "border-radius:6px;margin:0 0 1rem 0'><b>Untrained demo weights.</b> "
            "No <code>saved_models/best.weights</code> was found, so the model "
            "is randomly initialized and detections are noise.</div>"
        )
    elif getattr(detector, "demo_weights", False):
        which = ("the port's bundle (<code>ssdx_torch/serve/demo_weights.npz</code>, "
                 "trained by <code>python -m ssdx_torch.tools.make_demo_weights</code>)"
                 if getattr(detector, "weights_source", None) == PORT_BUNDLE else
                 "the JAX package's bundle (<code>ssdx/serve/demo_weights.npz</code>, "
                 "mAP@0.5&nbsp;&asymp;&nbsp;0.75 held-out)")
        banner = (
            "<div style='background:#b9770e;color:#fff;padding:0.6rem 1rem;"
            "border-radius:6px;margin:0 0 1rem 0'><b>Bundled demo weights.</b> "
            f"Serving {which}, trained on procedural street scenes "
            "(the /examples gallery's distribution) — not the Udacity-trained "
            "production model. Drop a real "
            "export at <code>saved_models/best.weights</code> to replace it.</div>"
        )
    else:
        banner = ""
    static_root = Path(static_dir) if static_dir else STATIC_DIR
    if batching and hasattr(detector, "preprocess_pil") and hasattr(detector, "predict"):
        from .batcher import MicroBatcher

        if batching_warmup is None:
            batching_warmup = getattr(detector, "device", torch.device("cpu")).type == "cuda"
        predictor = MicroBatcher(
            detector, max_batch=max_batch, max_wait_ms=max_wait_ms,
            warmup=batching_warmup,
            warmup_kwargs=dict(
                score_thresh=score_thresh, nms_thresh=nms_thresh,
                max_per_img=max_per_img,
            ),
        )
        lock = None  # the batcher's worker thread serializes device work
    else:
        predictor = detector
        lock = threading.Lock()  # single in-flight prediction (one device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _with_banner(html: str) -> bytes:
            return html.replace("<nav>", banner + "<nav>", 1).encode()

        def do_GET(self):
            if self.path == "/" or self.path == "/index.html":
                self._send(200, self._with_banner(_INDEX_HTML), "text/html; charset=utf-8")
            elif self.path == "/model-card":
                self._send(200, self._with_banner(_MODEL_CARD_HTML), "text/html; charset=utf-8")
            elif self.path == "/examples":
                self._send(200, self._with_banner(self._examples_html()), "text/html; charset=utf-8")
            elif self.path.startswith("/static/"):
                self._serve_static(self.path[len("/static/"):])
            elif self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def _examples_html(self) -> str:
            imgs = []
            if static_root.is_dir():
                imgs = sorted(
                    p.name
                    for p in static_root.iterdir()
                    if p.suffix.lower() in (".jpg", ".jpeg", ".png")
                )
            cards = "\n".join(
                f"<figure style='display:inline-block;margin:0.5rem'>"
                f"<img src='/static/{n}' width='380'>"
                f"<figcaption>{n} — download and upload on the "
                f"<a href='/'>home page</a> to run detection</figcaption>"
                f"</figure>"
                for n in imgs
            )
            return (
                "<!doctype html><html><body style='font-family:sans-serif;"
                "max-width:900px;margin:2rem auto'>"
                "<nav><a href='/' style='margin-right:1rem'>Home</a>"
                "<a href='/model-card' style='margin-right:1rem'>Model card</a>"
                "<a href='/examples'>Examples</a></nav><h1>Examples</h1>"
                "<p>Bundled sample street scenes (procedurally generated).</p>"
                + (cards or "<p>No example images bundled.</p>")
                + "</body></html>"
            )

        def _serve_static(self, rel: str):
            # resolve, then check containment (a string prefix check would
            # admit sibling directories sharing the prefix)
            target = (static_root / rel).resolve()
            if not target.is_relative_to(static_root.resolve()) or not target.is_file():
                self._send(404, b"not found", "text/plain")
                return
            ctype = {
                ".jpg": "image/jpeg", ".jpeg": "image/jpeg", ".png": "image/png",
                ".css": "text/css", ".js": "text/javascript",
            }.get(target.suffix.lower(), "application/octet-stream")
            self._send(200, target.read_bytes(), ctype)

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            payload = _parse_multipart(self.headers, body)
            if payload is None:  # also accept a raw image body
                payload = body
            try:
                pil_img = Image.open(io.BytesIO(payload)).convert("RGB")
            except Exception:
                self._send(400, b"could not decode image", "text/plain")
                return
            render = lambda: side_by_side_prediction(
                predictor,
                pil_img=pil_img,
                score_thresh=score_thresh,
                nms_thresh=nms_thresh,
                max_per_img=max_per_img,
                target_height=target_height,
            )
            if lock is None:
                combined = render()  # MicroBatcher coalesces device work
            else:
                with lock:
                    combined = render()
            buf = io.BytesIO()
            combined.save(buf, format="PNG")
            self._send(200, buf.getvalue(), "image/png")

    server = ThreadingHTTPServer((host, port), Handler)
    server.predictor = predictor  # expose batcher stats / close() to callers
    return server


def main() -> None:
    server = create_server()
    host, port = server.server_address[:2]
    print(f"ssdx_torch demo app listening on http://{host}:{port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
