"""Serving latency and batcher occupancy over live HTTP.

    python -m ssdx_torch.tools.bench_serving [--clients 8] [--requests 25]
        [--port 0] [--int8] [--cpu]

The port's counterpart of ``scripts/bench_serving.py``.  It starts the app's
threaded HTTP server (``serve/app.py``, ``create_server(det, batching=True,
batching_warmup=True)``) on the detector ``create_detector`` builds (the
BN-folded bf16 network with the stem and NMS kernels on the card; with
``--int8`` the int8 backbone, as ``SSDX_INT8=1`` serves it), waits for the
micro-batcher's bucket warm-up, and measures:

  * the first request after the warm-up;
  * 30 sequential requests from one closed-loop client: p50 / p95 / p99;
  * ``--clients`` closed-loop clients of ``--requests`` requests each:
    p50 / p95 / p99, requests/s, the batcher's occupancy (images per device
    dispatch) and its device dispatches.

Each request POSTs the first example scene and must come back 200 with a
PNG.  ``--port 0`` (the default) binds a free port.  Prints one JSON object
that names the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import threading
import time
import urllib.request

import torch

from ..serve.app import STATIC_DIR, create_detector, create_server

__all__ = ["bench", "main"]

WARMUP_TIMEOUT_S = 600.0


def _example_jpeg() -> bytes:
    return sorted(STATIC_DIR.glob("example_*.jpg"))[0].read_bytes()


def _post_predict(opener, url: str, jpeg: bytes) -> float:
    boundary = "x" + "b" * 30
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"t.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n"
    ).encode() + jpeg + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url + "/predict", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with opener.open(req, timeout=600) as r:
        ok = r.status == 200 and r.read(8) == b"\x89PNG\r\n\x1a\n"
    if not ok:
        raise AssertionError(f"POST /predict: status {r.status}, not a PNG")
    return time.perf_counter() - t0


def _pct(lat: list[float], q: float) -> float:
    s = sorted(lat)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def _card(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def bench(det, clients: int = 8, requests: int = 25, sequential: int = 30,
          port: int = 0) -> dict:
    """Serve ``det`` over HTTP on 127.0.0.1 and measure it (module
    docstring).  Returns the JSON object, with the batcher's counters and
    the number of requests sent beside the JAX script's keys."""
    server = create_server(det, host="127.0.0.1", port=port, batching=True,
                           batching_warmup=True)
    batcher = server.predictor  # the MicroBatcher create_server exposes
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # local only
    jpeg = _example_jpeg()
    try:
        if not batcher.warm.wait(WARMUP_TIMEOUT_S):
            raise TimeoutError(f"bucket warm-up still running after {WARMUP_TIMEOUT_S:.0f} s")
        warm_first = _post_predict(opener, url, jpeg)
        seq = [_post_predict(opener, url, jpeg) for _ in range(sequential)]

        base_batches, base_images = batcher.stats["batches"], batcher.stats["images"]
        lats: list[float] = []
        errors: list[BaseException] = []
        lock = threading.Lock()

        def client():
            try:
                mine = [_post_predict(opener, url, jpeg) for _ in range(requests)]
            except BaseException as e:  # fail the bench, not only the thread
                errors.append(e)
                return
            with lock:
                lats.extend(mine)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        batches = batcher.stats["batches"] - base_batches
        images = batcher.stats["images"] - base_images
        stats = dict(batcher.stats)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=10)
    return {
        "warm_first_request_s": round(warm_first, 4),
        "sequential": {"p50_s": round(_pct(seq, 0.5), 4),
                       "p95_s": round(_pct(seq, 0.95), 4),
                       "p99_s": round(_pct(seq, 0.99), 4)},
        "concurrent": {"clients": clients,
                       "requests": len(lats),
                       "p50_s": round(_pct(lats, 0.5), 4),
                       "p95_s": round(_pct(lats, 0.95), 4),
                       "p99_s": round(_pct(lats, 0.99), 4),
                       "throughput_req_s": round(len(lats) / wall, 2),
                       "batcher_occupancy": round(images / max(1, batches), 2),
                       "device_dispatches": batches},
        "requests_sent": 1 + sequential + clients * requests,
        "batcher_stats": stats,
        "int8": bool(getattr(det, "int8", False)),
        "device": _card(det.device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=25)
    ap.add_argument("--port", type=int, default=0, help="0: a free port")
    ap.add_argument("--int8", action="store_true", help="serve the int8 detector")
    ap.add_argument("--cpu", action="store_true", help="the plain float32 path on the CPU")
    args = ap.parse_args(argv)
    if args.int8 and args.cpu:
        ap.error("--int8 serves the BN-folded network of the card; not with --cpu")
    if args.int8:
        os.environ["SSDX_INT8"] = "1"  # what create_detector reads
    det = create_detector(device="cpu" if args.cpu else None)
    print(json.dumps(bench(det, args.clients, args.requests, port=args.port), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
