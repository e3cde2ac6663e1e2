"""Detections of the weights the app serves against the JAX package's bundle.

    python -m ssdx_torch.tools.bundle_agreement [--cpu]

Builds the app's detector (``create_detector()``: ``saved_models/best.weights``,
else the port's bundle ``ssdx_torch/serve/demo_weights.npz``, else the JAX
package's) and the same configuration on the JAX package's bundle
(``ssdx/serve/demo_weights.npz``), runs both on the three example scenes of
``ssdx/serve/static`` at the app's thresholds, and prints one JSON object:
the weights each detector serves, the detections per scene, and
``quant.detection_agreement`` of the two.  After ``make_demo_weights`` this
compares two trainings: the number informs, it is no check.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import quant
from ..api import Detector
from ..serve.app import BUNDLED_WEIGHTS, CLASS_TO_IDX, STATIC_DIR, create_detector

__all__ = ["agreement", "main"]

SERVE_KW = dict(score_thresh=0.2, nms_thresh=0.3, max_per_img=100)  # create_server's


def agreement(det_a, det_b) -> dict:
    """``quant.detection_agreement`` of two detectors on the example scenes,
    with each one's detections per scene."""
    from PIL import Image

    scenes = sorted(STATIC_DIR.glob("example_*.jpg"))
    images = np.concatenate([det_a.preprocess_pil(Image.open(p)) for p in scenes])
    a, b = (d.predict_batched(images, **SERVE_KW) for d in (det_a, det_b))
    count = lambda dets: [int(v) for v in dets.valid.sum(1).tolist()]
    return {**quant.detection_agreement(a, b), "detections_a": count(a),
            "detections_b": count(b)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="the plain float32 path on the CPU")
    args = ap.parse_args(argv)
    served = create_detector(device="cpu" if args.cpu else None)
    jax_bundle = Detector.from_weights(BUNDLED_WEIGHTS, CLASS_TO_IDX, device=served.device,
                                       stem_kernel=served.stem_kernel, dtype=served.dtype)
    out = {"a": str(served.weights_source), "b": str(BUNDLED_WEIGHTS),
           **agreement(served, jax_bundle)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
