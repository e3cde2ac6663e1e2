"""The benchmark's ResNet-50 cell (``r50coco_batch32``) and the VGG cell at
bs=128 (``bf16_batch128``) on the CPU, at a small size.

* A sound run of ``r50coco_batch32`` (float32, width 0.125, 8 images) is
  ``correct``; its line has the contract's shape; each of the cell's
  controls is not ``correct``: the program asked for DIoU in place of IoU
  (``nms_overlaps``: it keeps same-class pairs above IoU 0.5), every trunk
  conv's input rounded to float8, and ``trunk.layer3.2`` without its
  shortcut (``head_gap``); nor are answers that the program's heads do not
  give (half of them blanked, a score altered).
* The driver exits with a message, before it renders a scene, where the
  program cannot build the network (the parent commit's case).
* ``compare_r50``: the pairing reads answers of up to 200 detections and
  boxes with no area; ``nms_overlaps`` counts kept same-class overlaps.
* The per-layer readers of both cells, on a synthetic trace and span log;
  the yardstick of ``flops_r50`` (40.3 GFLOP an image).
* ``BENCHMARK.json``'s new entries and the files they name.

The card's own check is skipped: ``portbench.run.execute`` is given the CPU.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import core, flops_r50, run
from portbench.drivers import serve_batches_r50
from portbench.reference import compare_r50
from portbench.trace import DeviceOp, Trace
from ssdx_torch.utils import profiling
from ssdx_torch.utils.profiling import SpanRecord

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 77  # more than 32 signed bits
CPU = torch.device("cpu")
R50 = {"serve": {"dtype": "float32", "width_mult": 0.125,
                 "bn_calibration": {"scenes": 4, "stream": 1}},
       "traffic": {"batch": 8, "distinct_batches": 1, "check_batches": 1, "trace_batches": 1,
                   "workers": 4, "scene_size": 256}}
CONTROLS = {"diou": {"nms": "diou"}, "fp8_trunk": {"fp8_trunk": True},
            "no_shortcut": {"drop_shortcut": "trunk.layer3.2"}}


def _run(name: str, overrides: dict, trace: bool = False) -> dict:
    cell = core.load_cell(name, ROOT)
    line, lines = run.execute(cell, SEED, 0.3, trace, CPU, ROOT, overrides, t0=time.monotonic())
    assert lines[-1].startswith("check ")
    return line


def test_a_sound_r50_run_is_correct_and_its_line_has_the_contract_shape():
    line = _run("r50coco_batch32", R50)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "serve_images_per_s"}
    assert set(line["checks"]) == set(json.loads(
        (ROOT / "portbench/limits/r50coco_batch32.json").read_text()))
    json.dumps(line)


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_each_r50_control_is_not_correct(control):
    line = _run("r50coco_batch32", dict(R50, program=CONTROLS[control]))
    assert not line["correct"], line["checks"]


def _blank_half(monkeypatch):
    """The detector answers the first half of each batch and nothing for the rest."""
    from ssdx_torch.api import Detector

    real = Detector.predict_batched

    def half(self, images=None, **kw):
        d = real(self, images, **kw)
        with torch.inference_mode():
            d.valid[d.valid.shape[0] // 2:] = False
        return d

    monkeypatch.setattr(Detector, "predict_batched", half)


def _alter_answer(monkeypatch):
    """The top detection of every batch's first image reads another score."""
    from ssdx_torch.api import Detector

    real = Detector.predict_batched

    def altered(self, images=None, **kw):
        d = real(self, images, **kw)
        with torch.inference_mode():
            s = d.scores[0, 0]
            d.scores[0, 0] = s - 0.5 if s > 0.5 else s + 0.5
        return d

    monkeypatch.setattr(Detector, "predict_batched", altered)


@pytest.mark.parametrize("fault", [_blank_half, _alter_answer])
def test_a_postprocess_fault_is_not_correct(fault, monkeypatch):
    """Answers that the program's own heads do not give."""
    fault(monkeypatch)
    line = _run("r50coco_batch32", R50)
    assert not line["correct"], line["checks"]


def test_the_driver_stops_before_rendering_where_the_program_lacks_the_network(monkeypatch):
    import ssdx_torch.api

    class Old:  # a Detector without the ``architecture`` argument
        def __init__(self, class_to_idx, *, fold_bn=False, device=None, width_mult=1.0):
            pass

    monkeypatch.setattr(ssdx_torch.api, "Detector", Old)
    rendered = []
    monkeypatch.setattr(serve_batches_r50.scenes, "render_async",
                        lambda *a, **k: rendered.append(a))
    with pytest.raises(SystemExit, match="cannot build ssd300_resnet50_coco"):
        _run("r50coco_batch32", R50)
    assert not rendered


def _det(labels, scores, boxes):
    return {"labels": np.asarray(labels), "scores": np.asarray(scores, np.float32),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4)}


def test_compare_reads_200_detections_boxes_with_no_area_and_kept_overlaps():
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 250, (200, 2))
    boxes = np.concatenate([lo, lo + 40], 1)
    boxes[:3] = [[0, 10, 0, 30], [300, 5, 300, 9], [7, 300, 9, 300]]  # clamped off the frame
    ans = _det(np.arange(200) % 80, np.linspace(0.9, 0.1, 200), boxes)
    n = compare_r50.detection_numbers([ans], [dict(ans, cut=0.0)], 0.05, 200, 0.5)
    assert (n["invalid_answers"], n["wrong_answers"], n["lone"]) == (0, 0, 0)
    assert n["unpaired_share"] == 0.0
    assert n["nms_overlaps"] == compare_r50.overlaps(ans, 0.5)
    over = _det([3, 3, 4], [0.9, 0.8, 0.7], [[0, 0, 100, 100], [10, 0, 110, 100], [0, 0, 100, 100]])
    assert compare_r50.overlaps(over, 0.5) == 1  # IoU 0.82 in class 3; class 4 apart
    assert compare_r50.overlaps(over, 0.9) == 0
    too_many = _det(np.zeros(201), np.full(201, 0.5), np.tile([0, 0, 10, 10], (201, 1)))
    n = compare_r50.detection_numbers([too_many, None], [ans, ans], 0.05, 200, 0.5)
    assert n["invalid_answers"] == 2


def test_flops_r50_counts_the_published_network():
    layers = flops_r50.conv_layers()
    assert len(layers) == 53 + 6
    gmac = lambda pre: sum(l["macs"] for l in layers if l["name"].startswith(pre)) / 1e9
    assert gmac("trunk.conv1") == pytest.approx(0.21, abs=0.005)
    assert gmac("trunk.layer1") == pytest.approx(1.20, abs=0.005)
    assert gmac("trunk.layer2") == pytest.approx(1.89, abs=0.005)
    assert gmac("trunk.layer3") == pytest.approx(10.22, abs=0.005)
    assert gmac("extras") == pytest.approx(0.99, abs=0.005)
    assert gmac("head") == pytest.approx(5.65, abs=0.005)
    assert gmac("head0") == pytest.approx(4.52, abs=0.005)
    assert flops_r50.model_flops() == pytest.approx(40.3e9, rel=1e-3)
    by = {l["name"]: l for l in layers}
    assert (by["trunk.layer3.0.conv2"]["h_in"], by["trunk.layer3.0.conv2"]["h_out"]) == (38, 38)
    assert (by["trunk.layer2.0.downsample"]["h_in"], by["extras.4.1"]["h_out"]) == (75, 1)
    # B1's bound: a label compare for every pair, the IoU of the same-class ones
    t = flops_r50.nms_iou_bound_s([1600] * 32, [10_000] * 32, 1600)
    pairs = 32 * (1600 * 1599 - 1600 * 1599 // 2)
    assert t == pytest.approx((pairs + 32 * 10_000 * 14) / 67e12)


def _trace():
    ms = 1_000_000
    ops = [
        DeviceOp("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 0, 3 * ms,
                 frozenset({"portbench.predict_batched", "portbench.forward", "portbench.trunk"})),
        DeviceOp("vectorized_elementwise_kernel<add>", "kernel", 0, 1 * ms,
                 frozenset({"portbench.predict_batched", "portbench.forward", "portbench.trunk"})),
        DeviceOp("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 0, 2 * ms,
                 frozenset({"portbench.predict_batched", "portbench.forward", "portbench.heads"})),
        DeviceOp("ssdx::nms_sup_kernel<true>", "kernel", 0, ms // 10,
                 frozenset({"portbench.predict_batched"})),
        DeviceOp("radixSortKVInPlace", "kernel", 0, ms // 2,
                 frozenset({"portbench.predict_batched"})),
    ]
    t = Trace(window_s=0.02, busy_s=0.015, ops=ops)
    return t


def _spans():
    recs = []
    for i in range(2):
        root = 10 * i + 1
        recs += [SpanRecord("ssdx_torch.api.predict_batched", root, 0, root, 1, 10**9 + 10 * i,
                            10**9 + 10 * i + 9, {}),
                 SpanRecord("ssdx_torch.api.network", root + 1, root, root, 1, 10**9 + 10 * i,
                            10**9 + 10 * i + 4_000_000, {}),
                 SpanRecord("ssdx_torch.predict.postprocess", root + 2, root, root, 1,
                            10**9 + 10 * i + 5, 10**9 + 10 * i + 8,
                            {"nms_candidates": 1600 * 32, "nms_slots": 1600 * 32,
                             "nms_kept": 400 * 32})]
    return recs


def test_the_r50_readers_on_a_synthetic_window(monkeypatch):
    cell = core.load_cell("r50coco_batch32", ROOT)
    monkeypatch.setattr(profiling, "recent_spans", lambda: list(_spans()))
    facts = {"nms_candidates": [[1600] * 32], "same_class_pairs": [[20_000] * 32],
             "pair_top_k": 1600}
    ctx = core.Context(cell=cell, trace=_trace(), traced_iters=2, batch=32,
                       window={"seconds": 10.0, "images": 32_000}, facts=facts)
    got = {k: v["value"] for k, v in core.per_layer_metrics(ctx, ROOT).items()}
    assert got["trunk_ms.r50"] == pytest.approx(2.0)
    assert got["residual_glue_ms.r50"] == pytest.approx(0.5)
    assert got["heads_ms.r50"] == pytest.approx(1.0)
    assert got["conv_roofline.r50"] == pytest.approx(
        100 * flops_r50.conv_bound_s(32) / 2.5e-3)
    assert got["b1_nms_roofline.r50"] == pytest.approx(
        100 * flops_r50.nms_iou_bound_s([1600] * 32, [20_000] * 32, 1600) / 0.05e-3)
    assert got["host_network_ms.r50"] == pytest.approx(4.0)
    assert got["nms_kept_share.r50"] == pytest.approx(25.0)
    assert got["nms_slot_share.r50"] == pytest.approx(100.0)
    assert got["mfu.r50"] == pytest.approx(100 * 3200 * 40.3e9 / 989e12, rel=1e-3)
    assert got["postprocess_ms.r50"] == pytest.approx(0.3)
    assert got["idle_share.r50"] == pytest.approx(25.0)
    assert set(got) == {m["name"] for m in cell.per_layer}


def test_the_b128_readers_are_the_serve_cells():
    cell = core.load_cell("bf16_batch128", ROOT)
    assert {m["name"] for m in cell.per_layer} == {"mfu.b128", "idle_share.b128",
                                                   "b2_stem_roofline.b128"}
    ctx = core.Context(cell=cell, trace=Trace(window_s=0.1, busy_s=0.08), traced_iters=1,
                       batch=128, window={"seconds": 10.0, "images": 12_800})
    got = core.per_layer_metrics(ctx, ROOT)
    assert got["idle_share.b128"]["value"] == pytest.approx(20.0)
    assert got["mfu.b128"]["value"] == pytest.approx(
        core.reader("mfu.serve", ROOT)(ctx))
    assert "b2_stem_roofline.b128" not in got  # no stem kernel in this window


def test_the_benchmark_gains_the_two_cells_and_their_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["r50coco_batch32"]["config"] == "ssd300_resnet50_coco"
    assert cells["bf16_batch128"]["config"] == "ssd300_vgg16bn"
    assert all(cells[c]["chips"] == 1 for c in ("r50coco_batch32", "bf16_batch128"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["serve_images_per_s"]["workloads"][-2:] == ["bf16_batch128", "r50coco_batch32"]
    cfg = {c["name"]: c for c in bench["configs"]}["ssd300_resnet50_coco"]
    assert cfg["reduced"] == []
    conf = json.loads((ROOT / cfg["file"]).read_text())
    assert len(conf["classes"]) == 81 and conf["classes"][0] == "background"
    assert conf["classes"][1:4] == ["person", "bicycle", "car"]
    assert conf["postprocess"]["nms"] == "iou" and conf["postprocess"]["max_per_img"] == 200
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for name in cells:
        core.load_cell(name, ROOT)  # traffic, limits and readers found by name
