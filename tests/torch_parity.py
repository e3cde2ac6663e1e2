"""Shared inputs for the parity tests of the PyTorch port (tests/test_torch_*.py).

Weights and inputs are made with numpy from fixed seeds and handed to both
the JAX package and ``ssdx_torch`` as numpy arrays.

``jax_native_private`` gives the JAX package's C++ matcher
(``ssdx.ops.native``) a private build for the tests of one module: the
package builds its library into its own source directory, without a lock
or a temporary file, so test workers that ask for it at once can load a
half-written file and lose it for their whole session.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest

from ssdx.model import SSD300 as JaxSSD300

REPO = Path(__file__).resolve().parents[1]
DEMO_WEIGHTS = REPO / "ssdx" / "serve" / "demo_weights.npz"
EXAMPLES = sorted((REPO / "ssdx" / "serve" / "static").glob("example_*.jpg"))
CLASSES = {"biker": 0, "car": 1, "pedestrian": 2, "trafficLight": 3, "truck": 4}
JAX_NATIVE_SRC = REPO / "ssdx" / "ops" / "native" / "ssdx_native.cpp"
JAX_NATIVE_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]  # the package loader's own


def build_jax_native(dest: Path) -> Path:
    """Compile the JAX package's ``ssdx_native.cpp`` into ``dest`` with its
    loader's flags: a temporary file, renamed when complete."""
    out = Path(dest) / "libssdx_native.so"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *JAX_NATIVE_FLAGS, str(JAX_NATIVE_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


@contextlib.contextmanager
def private_jax_native(dest: Path):
    """``ssdx.ops.native`` loading a private build in ``dest``, whatever
    state its loader is in: ``_LIB`` points at the build and ``_lib`` and
    ``_tried`` are reset, so the package's own loader and argtypes load it.
    All three are restored on exit.  Neither builds nor reads the library in
    the source tree."""
    from ssdx.ops import native as jax_native

    lib = build_jax_native(dest)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", lib)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        yield jax_native


@pytest.fixture(scope="module", autouse=True)
def jax_native_private(tmp_path_factory):
    """Autouse in every test module that imports it: the module's tests
    reach the JAX package's matcher through :func:`private_jax_native`."""
    with private_jax_native(tmp_path_factory.mktemp("jax_native")) as mod:
        yield mod


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
