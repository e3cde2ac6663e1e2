"""The probe ops of the data-parallel repro tool (ssdx_torch/ops/repro.py) and
the tool itself (ssdx_torch/tools/repro_dist_kernels.py) on the CPU.

* ``ew_ref`` and ``mm_ref``, the plain versions that the CUDA kernels are held
  against on the card, against the TPU kernels' bodies: the two-line
  ``_ew_kernel`` and ``_mm_kernel`` of scripts/repro_shardmap_pallas.py,
  written out here and run through ``pl.pallas_call(..., interpret=True)``
  with the script's grid and block specs.  ``ew``: ``tanh`` of XLA and of
  PyTorch need not agree in the last bit: 1e-6 absolute on values below 1.5.
  ``mm``: exact bf16 products summed in f32 in another order: 1e-3 of the
  largest magnitude, the limit chip_smoke.py puts on the kernel.
* On a CPU tensor the wrappers run the plain versions and count no launch.
* The tool prints six ``ok`` lines at one rank (in this process) and at two
  ranks (two processes started the way a launcher starts them: ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and a case that raises
  prints ``ERROR`` and fails the run.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ssdx_torch.ops import repro
from ssdx_torch.tools import repro_dist_kernels as tool
from torch_dist import REPO, free_port


def _ew_kernel(x_ref, o_ref):
    o_ref[...] = jnp.tanh(x_ref[...]) * 1.5


def _mm_kernel(x_ref, y_ref, o_ref):
    o_ref[...] = jnp.dot(x_ref[...], y_ref[...], preferred_element_type=jnp.float32)


def test_ew_plain_version_equals_the_tpu_kernel_body():
    x = np.random.default_rng(0).normal(0, 1, (256, 256)).astype(np.float32)
    ref = pl.pallas_call(_ew_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                         interpret=True)(jnp.asarray(x))
    got = repro.ew_ref(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


@pytest.mark.parametrize("rows", [1024, 512])
def test_mm_plain_version_equals_the_tpu_kernel_body(rows):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (1024, 1024)), jnp.bfloat16)[:rows]
    y = jnp.asarray(rng.normal(0, 1, (1024, 1024)), jnp.bfloat16)
    ref = pl.pallas_call(
        _mm_kernel, grid=(rows // 256, 4),
        in_specs=[pl.BlockSpec((256, 1024), lambda i, j: (i, 0)),
                  pl.BlockSpec((1024, 256), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((256, 256), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((rows, 1024), jnp.float32), interpret=True)(x, y)
    to_torch = lambda a: torch.as_tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
    got = repro.mm_ref(to_torch(x), to_torch(y))
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and got.shape == (rows, 1024)
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()


def test_wrappers_take_the_plain_version_on_the_cpu():
    repro.launches_ew = repro.launches_mm = 0
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(repro.ew(x), torch.tanh(x) * 1.5)
    a = torch.randn(16, 32, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    b = torch.randn(32, 64, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    assert torch.equal(repro.mm(a, b), a.float() @ b.float())
    assert repro.launches_ew == 0 and repro.launches_mm == 0


def test_tool_prints_six_ok_lines_at_one_rank(capsys):
    rc = tool.main(["--cpu", "--timeout", "300"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "backend=gloo ranks=1" in out
    for case in tool.CASES:
        assert f"  {case} outside: ok (" in out
        assert f"  {case} inside mesh: ok (" in out
    assert out.count(": ok (") == 6 and "ERROR" not in out and "HANG" not in out
    assert not torch.distributed.is_initialized()


def test_tool_at_two_ranks_under_a_launcher_environment():
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2", "RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ssdx_torch.tools.repro_dist_kernels", "--cpu",
             "--timeout", "300"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("the tool's ranks were still running after 400 s: killed")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}"
    assert "backend=gloo ranks=2" in outs[0] and outs[0].count(": ok (") == 6
    assert "over 2 ranks" in outs[0] and ": ok (" not in outs[1]  # only rank 0 prints


def test_tool_reports_a_failing_case(capsys):
    lines = tool.run(["tiny"], tool.create_mesh("cpu"), log=print)
    out = capsys.readouterr().out
    assert lines["tiny outside"]["status"] == lines["tiny inside mesh"]["status"] == "ok"
    assert lines["tiny inside mesh"]["max_diff"] == 0.0
    assert "ERROR" not in out
    with pytest.raises(ValueError, match="unknown case"):
        tool._case_inputs("bogus", torch.device("cpu"))
    boom = tool._watchdog("boom", lambda: 1 / 0, torch.device("cpu"), 5.0, print)
    assert boom["status"] == "error" and "ZeroDivisionError" in boom["error"]
    assert "boom: ERROR ZeroDivisionError" in capsys.readouterr().out
    import time
    hang = tool._watchdog("slow", lambda: time.sleep(2) or torch.zeros(1), torch.device("cpu"),
                          0.2, print)
    assert hang == {"status": "hang"} and "slow: HANG" in capsys.readouterr().out
