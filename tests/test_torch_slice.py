"""The port's whole serving slice against the JAX package, on the CPU.

The bundled demo weights (the SynthDrive model) in float32, BN folded, run
through ssdx.api.Detector and ssdx_torch.api.Detector(device="cpu") on the
three example scenes: each image must give the same detections (count and
labels), boxes within 0.05 px and scores within 1e-4.  Then the port's HTTP
app must answer POST /predict with a PNG.
"""
import io
import threading

import httpx
import numpy as np
import pytest
import torch
from PIL import Image

from ssdx.api import Detector as JaxDetector
from ssdx_torch.api import Detector
from ssdx_torch.serve.app import create_server
from torch_parity import CLASSES, DEMO_WEIGHTS, EXAMPLES

KW = dict(score_thresh=0.2, nms_thresh=0.3, max_per_img=100)


def test_demo_weights_detections_match_jax():
    ref_det = JaxDetector.from_weights(DEMO_WEIGHTS, CLASSES)
    det = Detector.from_weights(DEMO_WEIGHTS, CLASSES, device="cpu")
    assert det.stem_kernel is False and det.dtype == torch.float32
    images = np.concatenate([det.preprocess_pil(Image.open(p)) for p in EXAMPLES])
    np.testing.assert_array_equal(images, np.concatenate(
        [ref_det.preprocess_pil(Image.open(p)) for p in EXAMPLES]))
    assert images.shape == (3, 300, 300, 3)

    refs, gots = ref_det.predict(images, **KW), det.predict(images, **KW)
    assert sum(len(r["labels"]) for r in refs) >= 3  # real detections
    for ref, got in zip(refs, gots):
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-4)


def test_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(CLASSES, width_mult=0.125)


@pytest.fixture(scope="module")
def server_url():
    det = Detector(CLASSES, fold_bn=True, width_mult=0.125, device="cpu")
    det.weights_loaded, det.demo_weights = False, False
    server = create_server(det, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.predictor.close()


def test_server_predict_returns_png(server_url):
    files = {"file": ("ex.jpg", EXAMPLES[0].read_bytes(), "image/jpeg")}
    r = httpx.post(server_url + "/predict", files=files, timeout=120)
    assert r.status_code == 200
    assert r.headers["content-type"] == "image/png"
    img = Image.open(io.BytesIO(r.content))
    assert img.format == "PNG" and img.size[1] == 512


@pytest.mark.parametrize("path,status,marker", [
    ("/", 200, "/predict"),
    ("/model-card", 200, "SSD300"),
    ("/examples", 200, "example_1.jpg"),
    ("/static/example_1.jpg", 200, None),
    ("/static/../app.py", 404, None),
])
def test_server_routes(server_url, path, status, marker):
    r = httpx.get(server_url + path)
    assert r.status_code == status
    if marker:
        assert marker in r.text
    if status == 200 and marker == "/predict":
        assert "Untrained demo weights" in r.text  # the random-init banner
