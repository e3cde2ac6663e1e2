"""Where the device time of the two stem kernels goes, on one GPU.

    python -m ssdx_torch.tools.profile_stem [--b3-batch 16] [--b2-batch 32]
                                            [--windows 1] [--b3-cuts]

B3 (``ops.stem_train``, ``csrc/stem_train.cu``): forwards + backwards at
``--b3-batch`` under ``torch.profiler``, over distinct inputs, and the
device time of every launch by kernel name (conv1_stats, stage2<0>, pool,
route, stage2<1>, dw2, dw1, colsum) and of the PyTorch glue between them
(the per-channel vectors, casts, the weight layouts), each named launch
beside its own bound: the operations of its contraction at the bf16 peak
against the bytes of its inputs read once and outputs written once
(:func:`b3_bounds`).  With ``--windows N`` it takes N profiler windows and
prints each launch's best and its spread (best .. worst).  Then the
library yardsticks of B3's two K = 27 launches alone (:func:`b3_library`):
cuDNN's conv1_1 forward and its weight gradient at the same shapes.  With
``--b3-cuts`` it also builds ``csrc/stem_train.cu`` with parts of
conv1_stats and dw1 cut out (:func:`b3_cut_variants`: dw1's fetch alone,
dw1 without its fetch, conv1_stats without its y1 stores or its epilogue)
and times each in B3's split: where each launch's time goes.

B2 (``ops.stem``, ``csrc/stem.cu``): the kernel at ``--b2-batch`` by CUDA
events and by profiler device time.

Prints the card (nvidia-smi name and power limit) first.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import re
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ssdx_torch.ops import _build
from ssdx_torch.ops import stem as stem_ops
from ssdx_torch.ops import stem_train as stem_train_ops
from ssdx_torch.tools.bench_int8_mm import WINDOW_PAD_S, cuda_ms, device_ms, fmt
from ssdx_torch.tools.roofline import bound_ms

H, C = 300, 64


def b3_bounds(B: int) -> dict:
    """Least device ms of each named B3 launch at batch ``B``: (ms, by)."""
    P = B * H * H
    act = P * C * 2          # one [B,300,300,64] bf16 map
    pooled = act // 4
    img = P * 3 * 2
    k27, k576 = 2 * P * C * 27, 2 * P * C * 576
    return {
        "conv1_stats": bound_ms(k27, img + act),
        "stage2<0>": bound_ms(k576, 2 * act),
        "pool": bound_ms(0, act + pooled),
        "route": bound_ms(0, 2 * act + pooled),
        "stage2<1>": bound_ms(k576, 4 * act),
        "dw2": bound_ms(k576, 3 * act),
        "dw1": bound_ms(k27, img + 2 * act),
    }


def b3_name(kernel_name: str) -> str:
    """The launch a device record belongs to: a B3 kernel by its short name
    (``stage2_kernel<1>`` -> ``stage2<1>``), anything else "glue"."""
    m = re.search(r"(conv1_stats|stage2|pool|route|dw2|dw1|colsum)_kernel(<\d>)?", kernel_name)
    if m is None:
        return "glue"
    return m.group(1) + (m.group(2) or "")


def stem_train_case(B: int, seed: int = 4, n: int = 3):
    """``n`` distinct (x, dp) pairs and the parameters of a B3 fwd+bwd."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std, mean=0.0: torch.randn(*s, generator=g, device=dev) * std + mean
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1),
         r(64, 64, 3, 3, std=0.08), r(64, std=0.3), r(64, std=0.1, mean=1.0), r(64, std=0.1))
    ps = [t.requires_grad_() for t in w]
    ins = [(r(B, H, H, 3, std=1.0).to(torch.bfloat16),
            r(B, H // 2, H // 2, C, std=1.0).to(torch.bfloat16)) for _ in range(n)]

    def run(x, dp):
        for p in ps:
            p.grad = None
        torch.autograd.backward(stem_train_ops.stem_train(x, *ps)[0], dp)

    return run, ins


def _b3_window(run, ins, iters):
    """(device us, count) by launch name over one profiler window of ``iters``
    calls; None if the window lost records (each launch must appear the
    same number of times in every call)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        for i in range(iters):
            run(*ins[i % len(ins)])
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    us, cnt = collections.defaultdict(float), collections.Counter()
    for e in events:
        k = b3_name(e.name)
        us[k] += e.time_range.elapsed_us()
        cnt[k] += 1
    if cnt and all(c % iters == 0 for k, c in cnt.items() if k != "glue"):
        return us, cnt
    return None


def b3_split(B: int = 16, iters: int = 10, tries: int = 3, windows: int = 1,
             log=print) -> dict | None:
    """Device ms per fwd+bwd of each B3 launch and of the glue, the best of
    ``windows`` profiler windows of ``iters`` calls each (``ms``) and the
    worst (``ms_max``); None if no window kept its records (a window that
    lost some is retried up to ``tries`` times)."""
    run, ins = stem_train_case(B)
    for x in ins:
        run(*x)
    torch.cuda.synchronize()
    got = []
    for _ in range(windows * tries):
        w = _b3_window(run, ins, iters)
        if w is not None:
            got.append(w)
        if len(got) == windows:
            break
    if not got:
        log("B3 split: not measured (the profiler lost records in every window)")
        return None
    bounds = b3_bounds(B)
    totals = [sum(us.values()) / iters / 1e3 for us, _ in got]
    order = ["conv1_stats", "stage2<0>", "pool", "route", "stage2<1>", "dw2", "dw1", "colsum",
             "glue"]
    cnt = got[0][1]
    split = {}
    spread = lambda hi: f" (.. {hi:.4f})" if len(got) > 1 else ""
    log(f"B3 split, bs={B}, device ms per forward + backward, best of {len(got)} window(s) "
        f"({min(totals):.4f} ms in all{spread(max(totals))}):")
    for k in order + sorted(set(cnt) - set(order)):
        if k not in cnt:
            continue
        per = [us[k] / iters / 1e3 for us, _ in got]
        ms, b = min(per), bounds.get(k)
        split[k] = {"ms": ms, "ms_max": max(per),
                    "launches": cnt[k] // iters if k != "glue" else cnt[k] / iters,
                    "bound_ms": None if b is None else b[0]}
        tail = "" if b is None else f", bound {b[0]:.4f} ms by {b[1]}"
        log(f"  {k:12s} {ms:8.4f} ms{spread(max(per))}  {100 * ms / min(totals):5.1f} %  "
            f"x{split[k]['launches']:g}{tail}")
    split["total_ms"], split["total_ms_max"] = min(totals), max(totals)
    return split


def b3_library(B: int = 16, log=print) -> dict:
    """One PyTorch call for each of B3's two K = 27 launches alone, at
    ``[B,300,300,3]`` -> 64 channels in bf16 channels-last (cuDNN): conv1_1's
    forward (``F.conv2d`` with the bias) and its weight gradient
    (``torch.nn.grad.conv2d_weight`` from a ``[B,300,300,64]`` cotangent);
    device ms by the profiler and ms by CUDA events."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bf, cl = torch.bfloat16, torch.channels_last
    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std
    w1 = r(C, 3, 3, 3, std=0.15).to(bf).contiguous(memory_format=cl)
    b1 = r(C, std=0.3).to(bf)
    ins = [(r(B, H, H, 3, std=1.0).to(bf).permute(0, 3, 1, 2),    # NCHW views of NHWC memory
            r(B, H, H, C, std=1.0).to(bf).permute(0, 3, 1, 2)) for _ in range(3)]
    calls = {"conv1_1 forward": lambda x, dy: F.conv2d(x, w1, b1, padding=1),
             "conv1_1 weight gradient":
                 lambda x, dy: torch.nn.grad.conv2d_weight(x, w1.shape, dy, padding=1)}
    res = {}
    for name, fn in calls.items():
        ev, dv = cuda_ms(fn, ins, iters=20), device_ms(fn, ins)
        res[name] = {"events_ms": ev, "device_ms": dv}
        log(f"library {name} bs={B} (cuDNN, bf16 channels-last): {fmt(dv, '.4f')} ms on the "
            f"device, {ev:.4f} ms by events")
    return res


def b2_times(B: int = 32, log=print) -> dict:
    """B2 at batch ``B``: ms by CUDA events and by profiler device time."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s, std: torch.randn(*s, generator=g, device=dev) * std
    w = (r(64, 3, 3, 3, std=0.15), r(64, std=0.3), r(64, 64, 3, 3, std=0.08), r(64, std=0.3))
    xs = [(r(B, H, H, 3, std=1.0).to(torch.bfloat16),) for _ in range(3)]
    fn = lambda x: stem_ops.stem_conv_pool(x, *w)
    ev = cuda_ms(fn, xs, iters=20)
    dv = device_ms(fn, xs, kernel="stem_kernel")
    log(f"B2 bs={B}: {ev:.4f} ms by events, {fmt(dv, '.4f')} ms on the device")
    return {"events_ms": ev, "device_ms": dv}


# ------------------------------------- B3's K = 27 launches with parts cut out


def b3_cut_variants(text: str) -> dict[str, str]:
    """``csrc/stem_train.cu`` whole and with one part of conv1_stats or dw1
    left out: what is left runs as before, so the time it saves is the part's
    share of its launch (dw1 without its fetch reads whatever its buffers
    hold).  Raises ValueError where the source no longer has the text a
    variant cuts at."""
    def cut(s, start, end):
        i, j = s.index(start), s.index(end, s.index(start))
        return s[:i] + s[j:]

    loop_end = "  }\n  stem90::cp_async_wait_all();\n\n  // acc[4j + 2h + e] is dW1"
    no_fetch = text
    for line in ("    if (tile + (int)gridDim.x < ntiles)\n      dw1_fetch(x, y1, dt1, tile + gridDim.x, "
                 "smem + ((it + 1) & 1) * kF_Buf, &bar[(it + 1) & 1]);\n",
                 "    sm90::mbar_wait(&bar[it & 1], (it >> 1) & 1);\n",
                 "  if ((int)blockIdx.x < ntiles) dw1_fetch(x, y1, dt1, blockIdx.x, smem, &bar[0]);\n"):
        if line not in no_fetch:
            raise ValueError(f"csrc/stem_train.cu has no {line!r}")
        no_fetch = no_fetch.replace(line, "")
    store = "      if (own_pixel(T, hc))\n        *reinterpret_cast<int4*>(y1 +"
    if store not in text:
        raise ValueError("csrc/stem_train.cu: conv1_stats' stores moved")
    return {
        "whole": text,
        "dw1 fetch only": cut(text, "    const stem90::Tile T = stem90::tile_of(tile);\n#pragma unroll\n"
                              "    for (int i = 0; i < kImPix * 8 / kWide", loop_end),
        "dw1 without fetch": no_fetch,
        "conv1_stats without y1 stores": text.replace(store, store.replace("(own_pixel(T, hc))",
                                                                           "(own_pixel(T, hc) && T.b < 0)")),
        "conv1_stats without epilogue": cut(text, "    // + b1, bf16, the sums of the rounded values",
                                            "    sm90::named_barrier(1 + wg, 128);\n    for (int v = t;"),
    }


def b3_cuts(B: int = 16, log=print) -> dict:
    """Device ms of conv1_stats, dw1 and all of B3 for each of
    :func:`b3_cut_variants`, built at once and swapped in for the module's
    library one after another (best of 3 profiler windows each)."""
    text = (_build.CSRC / "stem_train.cu").read_text()
    procs = {}
    for k, v in b3_cut_variants(text).items():
        src = _build_variant("stem_train " + k, v)
        lib = src.with_suffix(".so")
        cmd = [_build._nvcc(), *_build._flags("stem_train"), "-I", str(_build.CSRC), "-o",
               str(lib), str(src)]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), lib)
    real = stem_train_ops._kernel()
    res = {}
    try:
        for k, (p, lib) in procs.items():
            outp, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {k} variant:\n{outp}")
            var = ctypes.CDLL(str(lib))
            for name in ("ssdx_st_conv1", "ssdx_st_stage2", "ssdx_st_pool", "ssdx_st_route",
                         "ssdx_st_dw2", "ssdx_st_dw1", "ssdx_st_colsum"):
                fn = getattr(var, name)
                fn.argtypes, fn.restype = getattr(real, name).argtypes, ctypes.c_int
            stem_train_ops._lib = var
            sp = b3_split(B, windows=3, log=lambda *a: None)
            if sp is None:
                log(f"B3 cut {k!r}: not measured (the profiler lost records)")
                continue
            res[k] = {n: sp[n]["ms"] for n in ("conv1_stats", "dw1")} | {"total": sp["total_ms"]}
            log(f"B3 cut {k:30s} conv1_stats {res[k]['conv1_stats']:.4f} ms, dw1 "
                f"{res[k]['dw1']:.4f} ms, B3 {res[k]['total']:.4f} ms (device, best of 3 windows)")
    finally:
        stem_train_ops._lib = real
    return res


def _build_variant(name: str, text: str) -> Path:
    out_dir = _build.BUILD_DIR / "stem_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(text.encode()).hexdigest()[:12]
    src = out_dir / f"{re.sub(r'[^a-z0-9_]', '_', name)}-{h}.cu"
    src.write_text(text)
    return src


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b3-batch", type=int, default=16)
    ap.add_argument("--b2-batch", type=int, default=32)
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--b3-cuts", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stem: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    b3_split(args.b3_batch, windows=args.windows)
    b3_library(args.b3_batch)
    b2_times(args.b2_batch)
    if args.b3_cuts:
        b3_cuts(args.b3_batch)


if __name__ == "__main__":
    main()
