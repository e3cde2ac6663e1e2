"""The port's whole serving slice against the JAX package, on the CPU.

The bundled demo weights (the SynthDrive model) in float32, BN folded, run
through ssdx.api.Detector and ssdx_torch.api.Detector(device="cpu") on the
three example scenes: each image must give the same detections (count and
labels), boxes within 0.05 px and scores within 1e-4.  Then the port's HTTP
app must answer POST /predict with a PNG.

The int8 slice, the same way: both detectors calibrate and quantize on one
example scene (each with its own framework's calibration) and predict it;
the detections must agree at a match rate of at least 0.9.
"""
import io
import threading
from types import SimpleNamespace

import httpx
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ssdx.api import Detector as JaxDetector
from ssdx.model import SSD300 as JaxSSD300
from ssdx.quant import detection_agreement as jax_agreement
from ssdx_torch import quant
from ssdx_torch.api import Detector
from ssdx_torch.model import SSD300
from ssdx_torch.predict import Detections
from ssdx_torch.serve.app import create_detector, create_server
from ssdx_torch.train.step import TrainState
from ssdx_torch.weights import state_dict_from_jax
from torch_parity import CLASSES, DEMO_WEIGHTS, EXAMPLES, random_variables

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


def test_int8_slice_matches_jax_on_demo_weights():
    """The whole int8 slice at full width in float32: the port's
    quantize_int8(backend="plain") against ssdx's quantize_int8(backend=
    "xla") on the bundled weights, one scene for calibration and prediction.
    Calibration differs in the last float32 digits between the frameworks,
    so single requantized values may differ by a step; the detections are
    compared through detection_agreement: match rate at least 0.9."""
    ref_det = JaxDetector.from_weights(DEMO_WEIGHTS, CLASSES)
    det = Detector.from_weights(DEMO_WEIGHTS, CLASSES, device="cpu")
    image = det.preprocess_pil(Image.open(EXAMPLES[0]))
    ref_scales = ref_det.quantize_int8(image, backend="xla")
    scales = det.quantize_int8(image, backend="plain")
    assert det.quant_params is not None and set(scales) == set(ref_scales)
    for name, r in ref_scales.items():  # f32 calibration: summation order only
        np.testing.assert_allclose(scales[name], r, rtol=1e-3, atol=1e-5, err_msg=name)

    ref = ref_det.predict_batched(image, **KW)
    got = det.predict_batched(image, **KW)
    assert int(got.valid.sum()) >= 1
    as_torch = Detections(*(torch.as_tensor(np.array(x)) for x in ref))
    agree = quant.detection_agreement(as_torch, got)
    assert agree["match_rate"] >= 0.9, agree
    assert agree == pytest.approx(jax_agreement(ref, SimpleNamespace(
        **{k: jnp.asarray(v.numpy()) for k, v in got._asdict().items()})), abs=1e-6)


def test_quantize_int8_contract():
    """quantize_int8 needs fold_bn; backend="kernel" needs a CUDA detector;
    "auto" on a CPU detector takes the plain walk and forward then runs it."""
    images = np.random.default_rng(0).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="fold_bn"):
        Detector(CLASSES, width_mult=0.125, device="cpu").quantize_int8(images)
    det = Detector(CLASSES, fold_bn=True, width_mult=0.125, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        det.quantize_int8(images, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        det.quantize_int8(images, backend="pallas")
    assert det.quant_params is None
    float_loc, _ = det.forward(images)
    scales = det.quantize_int8(images, calib_batch=1)  # two chunks, folded by maximum
    assert len(scales) == 21 and scales["ConvBNRelu_2"].shape == (8,)
    assert det._int8_forward is quant.apply_int8
    loc, cls = det.forward(images)
    assert loc.shape == (2, 8732, 4) and cls.shape == (2, 8732, 6)
    want = quant.apply_int8(det.quant_params, det._stem(torch.as_tensor(images)), det.dtype)
    torch.testing.assert_close(loc, want[0], rtol=0, atol=0)
    assert not torch.equal(loc, float_loc)  # the int8 route, not the float model


def test_create_detector_honours_ssdx_int8(monkeypatch):
    monkeypatch.setenv("SSDX_INT8", "1")
    det = create_detector(device="cpu")
    assert det.int8 is True and det.quant_params is not None and det.demo_weights
    monkeypatch.delenv("SSDX_INT8")
    assert not hasattr(create_detector(device="cpu"), "int8")


def test_load_train_state_matches_jax():
    """Adopt a train state's weights and statistics, fold, and match ssdx's
    load_train_state + folded forward on the heads (width 0.125, float32;
    1e-4: two frameworks' float32 convs)."""
    variables = random_variables(0.125, seed=4)
    images = np.random.default_rng(1).normal(0, 1, (1, 300, 300, 3)).astype(np.float32)
    fake = SimpleNamespace(model=SimpleNamespace(fold_bn=True))
    JaxDetector.load_train_state(fake, SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    ref_loc, ref_cls = JaxSSD300(num_classes=6, width_mult=0.125, fold_bn=True).apply(
        fake.variables, jnp.asarray(images), train=False)

    model = SSD300(6, width_mult=0.125)
    model.load_state_dict(state_dict_from_jax(variables, fold_bn=False))
    det = Detector(CLASSES, fold_bn=True, width_mult=0.125, device="cpu", rng_seed=9)
    before, _ = det.forward(images)
    det.load_train_state(TrainState(model=model, optimizer=None))
    loc, cls = det.forward(images)
    assert not torch.allclose(loc, before)
    np.testing.assert_allclose(loc.numpy(), np.asarray(ref_loc), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), rtol=1e-4, atol=1e-4)


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


def test_mesh_slice_matches_jax_on_demo_weights():
    """The data-parallel slice: ssdx's Detector under a two-device mesh (the
    three scenes are padded to four and cut again) against the port's
    Detector in a one-rank process group, on the bundled weights in float32.
    The same limits as the meshless slice above: equal labels, boxes within
    0.05 px, scores within 1e-4."""
    import jax

    from ssdx.mesh import create_mesh as jax_create_mesh
    from ssdx_torch import mesh as M
    from torch_dist import free_port

    ref_det = JaxDetector.from_weights(DEMO_WEIGHTS, CLASSES,
                                       mesh=jax_create_mesh(jax.devices()[:2]))
    M.initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                             device="cpu")
    try:
        det = Detector.from_weights(DEMO_WEIGHTS, CLASSES, mesh=M.create_mesh("cpu"))
        assert det.mesh.backend == "gloo" and det.device.type == "cpu"
        images = np.concatenate([det.preprocess_pil(Image.open(p)) for p in EXAMPLES])
        gots = det.predict(images, **KW)
    finally:
        M.finalize_distributed()
    refs = ref_det.predict(images, **KW)
    assert len(refs) == len(gots) == 3 and sum(len(r["labels"]) for r in refs) >= 3
    for ref, got in zip(refs, gots):
        np.testing.assert_array_equal(got["labels"], ref["labels"])
        np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0, atol=0.05)
        np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=1e-4)


def test_eval_slice_runs_the_native_matcher_and_the_mesh_arguments(tmp_path, monkeypatch):
    """The eval slice end to end at width 0.25: a SynthDrive directory from
    the port's generator, weights exported by the port and read back,
    evaluate_weights on the CPU: the mAP accumulator goes through the C++
    matcher, and the result equals a second pass through the numpy matcher
    exactly (the two matchers flag the same detections)."""
    from ssdx_torch.data import synth
    from ssdx_torch.eval import map as mapmod
    from ssdx_torch.eval.run import evaluate_weights
    from ssdx_torch.model import init_variables
    from ssdx_torch.train.checkpoint import save_params

    synth.generate_dataset(tmp_path / "test", 6, seed=3, size=128)
    v = init_variables(6, seed=0, width_mult=0.25)
    w = save_params(v["params"], v["batch_stats"], tmp_path / "m.weights")
    kw = dict(batch_size=4, bfloat16=False, num_workers=2, width_mult=0.25, score_thresh=0.01,
              device="cpu")
    calls = []
    real = mapmod._native.match_detections_ignore
    monkeypatch.setattr(mapmod._native, "match_detections_ignore",
                        lambda *a: calls.append(1) or real(*a))
    out = evaluate_weights(w, tmp_path / "test", **kw)
    assert calls and np.isfinite(out["testing loss"]) and len(out["classes"]) == 5
    monkeypatch.setattr(mapmod._native, "available", lambda: False)
    plain = evaluate_weights(w, tmp_path / "test", **kw)
    assert out["mAP"]["map_50"] == plain["mAP"]["map_50"]
    np.testing.assert_array_equal(out["mAP"]["map_per_class"], plain["mAP"]["map_per_class"])
    assert out["testing loss"] == plain["testing loss"]
