"""Build the CUDA sources in ``ssdx_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``ssdx_torch/_build/lib<name>-<hash>.so``
(the hash covers the source, the headers ``csrc/*.cuh`` and the flags, so
an edited source or header rebuilds).
No PyTorch headers are involved, which keeps a build to seconds.  Build
errors propagate as ``RuntimeError`` with nvcc's output.

``build_host`` does the same with ``g++`` for a host-only ``csrc/<name>.cpp``
(no CUDA); a machine without a compiler gets ``None`` from it, not an error.
Nothing is ever built into the source tree.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build", "load", "build_host", "BUILD_DIR", "build_logs"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# nms.cu and int8_conv.cu must not contract multiply-adds: the DIoU and the
# int8 epilogue have to round like their plain PyTorch versions, operation
# by operation.
_EXTRA = {"nms": ["-fmad=false"], "int8_conv": ["-fmad=false"]}

_HOST = ["-O3", "-march=native", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()  # one build at a time within the process
build_logs: dict[str, str] = {}  # nvcc's output (registers, spills) per source


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return exe


def _flags(name: str) -> list[str]:
    return _COMMON + _EXTRA.get(name, [])


def _target(name: str) -> Path:
    """The library's path: the hash covers the source, every header of
    ``csrc`` (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named sources that are not built yet, all at once."""
    with _lock:
        return _compile(names)


def _compile(names) -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)[name]))
        return _libs[name]


def build_host(name: str) -> Path | None:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless it is built already;
    the library's path, or None where no compiler is present or it fails."""
    exe = shutil.which("g++")
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes() + " ".join(_HOST).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{h}.so"
    with _lock:
        if out.exists():
            return out
        if exe is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            p = subprocess.run([exe, *_HOST, str(src), "-o", str(tmp)], capture_output=True,
                               text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            build_logs[name] = str(e)
            return None
        build_logs[name] = p.stdout + p.stderr
        if p.returncode != 0:
            return None
        os.replace(tmp, out)
        return out
