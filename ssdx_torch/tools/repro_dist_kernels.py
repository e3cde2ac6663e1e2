"""Hand-written kernels outside and inside the data-parallel wrapper.

The port's counterpart of ``scripts/repro_shardmap_pallas.py``, which bisects
"a kernel hangs or fails only inside the data-parallel wrapper" with three
cases of increasing size:

  tiny    ``ops.repro.ew``: tanh(x) * 1.5 on a [256,256] float32 input
  matmul  ``ops.repro.mm``: [1024,1024] x [1024,1024] bf16 -> float32, x
          sharded by rows, y replicated
  stem    the serving stem kernel (``ops.stem.stem_conv_pool``) at bs=8 on
          the BN-folded ``init_variables(6, 0)``

Each case runs the kernel on the whole input outside any collective (the
control), then on this rank's shard inside the mesh, gathers the shards from
every rank and compares the two results.  Every run is under a watchdog (a
hung collective is the very thing the tool looks for) and prints one line:
``ok (ms)``, ``ERROR ...`` or ``HANG``.  A case that fails only inside the mesh
is the wrapper's fault, not the kernel's.  The exit code is 0 only when every
line is ``ok``.

The mesh has one rank by default (the smallest wrapper: a process group of
one, whose collectives do run) and as many as ``WORLD_SIZE`` says under a
launcher:

    python -m ssdx_torch.tools.repro_dist_kernels [tiny] [matmul] [stem]
    torchrun --nproc-per-node 2 -m ssdx_torch.tools.repro_dist_kernels
"""
from __future__ import annotations

import argparse
import socket
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..export import fold_batchnorm
from ..mesh import (all_gather_batch, create_mesh, finalize_distributed,
                    initialize_distributed, shard_batch)
from ..model import init_variables
from ..ops import _build, repro
from ..ops.stem import stem_conv_pool
from ..weights import state_dict_from_jax

__all__ = ["CASES", "run", "main", "free_port"]

CASES = ("tiny", "matmul", "stem")
# inside against outside: the same arithmetic on the same rows.  The kernels
# give equal bits; a plain CPU product may block a half-height matrix
# differently, so the tool's own limit is relative to the largest magnitude.
MATCH_RTOL = 1e-3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watchdog(name: str, fn, dev, timeout_s: float, log) -> dict:
    """Run ``fn()`` in a thread and wait for the device; report ok / ERROR /
    HANG.  A hung thread is a daemon and dies with the process."""
    result: dict = {}

    def target():
        try:
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            float(out.float().sum())  # on the host: the work really finished
            result["ms"] = (time.perf_counter() - t0) * 1e3
            result["out"] = out
        except Exception as e:  # noqa: BLE001 - the tool reports any failure as a line
            result["err"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        log(f"  {name}: HANG (> {timeout_s:.0f}s)")
        return {"status": "hang"}
    if "err" in result:
        log(f"  {name}: ERROR {result['err']}")
        return {"status": "error", "error": result["err"]}
    return {"status": "ok", **result}


def _case_inputs(case: str, dev):
    """(kernel of the sharded argument, the sharded argument), from seed 0."""
    rng = np.random.default_rng(0)
    if case == "tiny":
        x = torch.as_tensor(rng.normal(0, 1, (256, 256)).astype(np.float32), device=dev)
        return repro.ew, x
    if case == "matmul":
        x, y = (torch.as_tensor(rng.normal(0, 1, (1024, 1024)).astype(np.float32),
                                device=dev).to(torch.bfloat16) for _ in range(2))
        return (lambda xs: repro.mm(xs, y)), x
    if case == "stem":
        sd = state_dict_from_jax(fold_batchnorm(init_variables(6, 0)), True)
        w = [sd[k].to(dev) for k in ("layers.0.conv.weight", "layers.0.conv.bias",
                                     "layers.1.conv.weight", "layers.1.conv.bias")]
        x = torch.as_tensor(rng.normal(0, 1, (8, 300, 300, 3)).astype(np.float32), device=dev)
        # the kernel computes in bf16; the plain version on the CPU in f32
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        return (lambda xs: stem_conv_pool(xs, *w, dtype)), x
    raise ValueError(f"unknown case {case!r}; choose from {CASES}")


def run(cases=CASES, mesh=None, timeout_s: float = 120.0, log=print) -> dict:
    """Run the cases on ``mesh`` (every rank calls this); returns
    ``{"<case> outside" | "<case> inside mesh": {"status", "ms", "max_diff"}}``."""
    mesh = create_mesh() if mesh is None else mesh
    dev = mesh.device
    if dev.type == "cuda":
        _build.build("repro", "stem")  # compile before the watchdog's clock starts
    lines = {}
    for case in cases:
        log(f"case {case}:")
        kernel, x = _case_inputs(case, dev)
        outside = _watchdog(f"{case} outside", lambda: kernel(x), dev, timeout_s, log)
        if outside["status"] == "ok":
            log(f"  {case} outside: ok ({outside['ms']:.1f} ms)")
        whole = outside.pop("out", None)
        lines[f"{case} outside"] = outside

        name = f"{case} inside mesh"
        inside = _watchdog(
            name, lambda: all_gather_batch(kernel(shard_batch(x, mesh)), mesh), dev,
            timeout_s, log)
        got = inside.pop("out", None)
        if inside["status"] == "ok" and whole is not None:
            diff = (got.float() - whole.float()).abs().max().item()
            inside["max_diff"] = diff
            if got.shape != whole.shape or not diff <= MATCH_RTOL * whole.float().abs().max().item():
                inside = {"status": "error", "error": f"differs from outside by {diff:.3e}"}
                log(f"  {name}: ERROR {inside['error']}")
            else:
                log(f"  {name}: ok ({inside['ms']:.1f} ms), max |inside - outside| = {diff:.1e} "
                    f"over {mesh.size} rank{'s' * (mesh.size > 1)}")
        elif inside["status"] == "ok":
            log(f"  {name}: ok ({inside['ms']:.1f} ms), nothing outside to compare with")
        lines[name] = inside
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cases", nargs="*", help=f"any of {', '.join(CASES)}; default all")
    ap.add_argument("--cpu", action="store_true", help="plain versions on the CPU, over gloo")
    ap.add_argument("--timeout", type=float, default=120.0, help="watchdog seconds per run")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    initialize_distributed(device=dev)
    if not dist.is_initialized():  # one rank: still a real process group
        initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1,
                               rank=0, device=dev)
    mesh = create_mesh(dev)
    say = print if mesh.rank == 0 else (lambda *_: None)
    say(f"device={mesh.device} backend={mesh.backend} ranks={mesh.size}")
    lines = run(args.cases or CASES, mesh, args.timeout,
                log=lambda m: (say(m), sys.stdout.flush()))
    if not any(v["status"] == "hang" for v in lines.values()):
        finalize_distributed()  # after a hung collective this would hang too
    return 0 if all(v["status"] == "ok" for v in lines.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
