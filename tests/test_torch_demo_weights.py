"""The port's demo-weights trainer (ssdx_torch/tools/make_demo_weights.py)
and the app's choice of weights, on the CPU.

A tiny run (16 scenes of 128x128: one bs=16 step an epoch, 2 epochs, an
evaluation after each; width 0.25 through ``main``) writes ``--out`` and the
float16 bundle into a temporary directory, never into the package.
``create_detector`` then serves, in order: the given weights, the port's
bundle, the JAX package's bundle; the model card names the bundle served.
"""
import threading
import urllib.request

import numpy as np
import pytest

from ssdx_torch.export import fold_batchnorm
from ssdx_torch.serve import app
from ssdx_torch.tools import make_demo_weights
from ssdx_torch.weights import load_params

WM = 0.25


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo_weights")
    lines = []
    rc = make_demo_weights.main(
        ["--images", "16", "--size", "128", "--epochs", "2", "--eval-every", "1",
         "--min-map", "0", "--cpu", "--out", str(d / "best.weights"),
         "--bundle", str(d / "demo_weights.npz")], width_mult=WM, log=lines.append)
    return rc, lines, d


def test_tiny_run_writes_weights_and_bundle(trained):
    rc, lines, d = trained
    assert rc == 0, lines
    assert [ln.split()[:2] for ln in lines if ln.startswith("epoch")] == [
        ["epoch", "0"], ["epoch", "1"]]
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines if ln.startswith("epoch"))
    assert lines[-1].startswith("RESULT: PASS  best mAP@0.5=")
    out, bundle = load_params(d / "best.weights"), load_params(d / "demo_weights.npz")
    k = out["params"]["ConvBNRelu_0"]["Conv_0"]["kernel"]
    np.testing.assert_allclose(bundle["params"]["ConvBNRelu_0"]["Conv_0"]["kernel"], k,
                               rtol=1e-3, atol=1e-4)  # float16 in the bundle


def _kernel(det):
    return det.model.layers[0].conv.weight.detach().numpy()


def test_app_prefers_the_port_bundle(trained, monkeypatch):
    _, _, d = trained
    monkeypatch.setattr(app, "DEFAULT_WEIGHTS", str(d / "absent.weights"))
    monkeypatch.setattr(app, "PORT_BUNDLE", d / "demo_weights.npz")
    det = app.create_detector(device="cpu", width_mult=WM)
    assert det.weights_source == d / "demo_weights.npz"
    assert det.weights_loaded and det.demo_weights
    folded = fold_batchnorm(load_params(d / "demo_weights.npz"))  # the app folds BN at load
    k = folded["params"]["ConvBNRelu_0"]["Conv_0"]["kernel"].numpy()  # HWIO
    np.testing.assert_allclose(_kernel(det), k.transpose(3, 2, 0, 1), rtol=1e-6)

    server = app.create_server(det, host="127.0.0.1", port=0, batching=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(f"http://127.0.0.1:{server.server_address[1]}/model-card") as r:
            page = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert "the port's bundle" in page and "ssdx_torch/serve/demo_weights.npz" in page

    given = app.create_detector(d / "best.weights", device="cpu", width_mult=WM)
    assert given.weights_source == d / "best.weights" and not given.demo_weights


def test_app_serves_the_jax_bundle_without_the_port_bundle(tmp_path, monkeypatch):
    monkeypatch.setattr(app, "DEFAULT_WEIGHTS", str(tmp_path / "absent.weights"))
    monkeypatch.setattr(app, "PORT_BUNDLE", tmp_path / "absent.npz")
    assert app.serving_weights() == app.BUNDLED_WEIGHTS
    det = app.create_detector(device="cpu")
    assert det.weights_source == app.BUNDLED_WEIGHTS and det.demo_weights


def test_bundle_agreement_of_the_jax_bundle_with_itself(tmp_path, monkeypatch, capsys):
    """tools/bundle_agreement.py with no port bundle: the app serves the JAX
    bundle, which agrees with itself on the three example scenes."""
    import json

    from ssdx_torch.tools import bundle_agreement

    monkeypatch.setattr(app, "DEFAULT_WEIGHTS", str(tmp_path / "absent.weights"))
    monkeypatch.setattr(app, "PORT_BUNDLE", tmp_path / "absent.npz")
    assert bundle_agreement.main(["--cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["a"] == out["b"] == str(app.BUNDLED_WEIGHTS)
    assert out["detections_a"] == out["detections_b"] and sum(out["detections_a"]) > 0
    assert out["match_rate"] == 1.0 and out["max_score_delta"] == 0.0
    assert abs(out["mean_matched_iou"] - 1.0) < 1e-6
