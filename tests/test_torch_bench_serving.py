"""The port's serving bench (ssdx_torch/tools/bench_serving.py) on the CPU.

A width-0.25 detector behind the app's HTTP server with micro-batching and
bucket warm-up, two closed-loop clients: the JSON has every key of
scripts/bench_serving.py's output, every request comes back 200 with a PNG
(the bench raises otherwise), and the batcher counted one image for each
request sent (warm-up dispatches bypass its counters).
"""
from ssdx_torch.api import Detector
from ssdx_torch.serve.app import CLASS_TO_IDX
from ssdx_torch.tools import bench_serving

JAX_KEYS = {  # scripts/bench_serving.py's output
    "warm_first_request_s": None,
    "sequential": {"p50_s", "p95_s", "p99_s"},
    "concurrent": {"clients", "requests", "p50_s", "p95_s", "p99_s", "throughput_req_s",
                   "batcher_occupancy", "device_dispatches"},
}


def test_bench_answers_every_request_and_reports_the_jax_keys():
    det = Detector(CLASS_TO_IDX, width_mult=0.25, device="cpu")
    out = bench_serving.bench(det, clients=2, requests=3, sequential=4)
    for key, sub in JAX_KEYS.items():
        assert key in out
        if sub is not None:
            assert sub <= set(out[key]), (key, out[key])
    assert out["concurrent"]["clients"] == 2 and out["concurrent"]["requests"] == 6
    assert out["requests_sent"] == 1 + 4 + 6
    assert out["batcher_stats"]["images"] == out["requests_sent"]
    assert 1 <= out["concurrent"]["device_dispatches"] <= 6
    assert 1.0 <= out["concurrent"]["batcher_occupancy"] <= 2.0
    seq = out["sequential"]
    assert 0 < seq["p50_s"] <= seq["p95_s"] <= seq["p99_s"]
    assert out["concurrent"]["throughput_req_s"] > 0 and out["warm_first_request_s"] > 0
    assert out["int8"] is False and out["device"] == {"platform": "cpu"}
