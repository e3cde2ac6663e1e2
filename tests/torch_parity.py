"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*.py).

Weights and inputs are made with numpy from fixed seeds and handed to both
the JAX package and ``ssdx_torch`` as numpy arrays.
"""
from __future__ import annotations

from pathlib import Path

import jax
import numpy as np

from ssdx.model import SSD300 as JaxSSD300

REPO = Path(__file__).resolve().parents[1]
DEMO_WEIGHTS = REPO / "ssdx" / "serve" / "demo_weights.npz"
EXAMPLES = sorted((REPO / "ssdx" / "serve" / "static").glob("example_*.jpg"))
CLASSES = {"biker": 0, "car": 1, "pedestrian": 2, "trafficLight": 3, "truck": 4}


def flatten(tree, pre: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"/a/b": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree)}


def random_variables(width_mult: float, seed: int = 0, num_classes: int = 6) -> dict:
    """A flax SSD300 ``{'params', 'batch_stats'}`` tree of numpy arrays.

    The tree's layout comes from the JAX model (``jax.eval_shape`` of its
    init, which compiles nothing); the values are numpy draws: He-scaled
    kernels, small biases, and randomised BN scale, bias, mean and var
    (flax's identity BN would make folding trivial).
    """
    shapes = jax.eval_shape(
        JaxSSD300(num_classes=num_classes, width_mult=width_mult).init_variables,
        jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return rng.normal(0, std, s.shape).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))
