"""The experiment tool (ssdx_torch.tools.stem_train_experiments) on the CPU at
a tiny size: every variant builds and runs one forward and backward, the
variants that run B5 and B6 take the plain route there (no kernel launch is
counted), and gradients reach the parameters each variant differentiates.
Timing and the kernels themselves need the card (chip_smoke.py phase 16).
"""
import pytest
import torch

from ssdx_torch.ops import bn_relu_pool as brp_ops
from ssdx_torch.ops import pool as pool_ops
from ssdx_torch.tools import stem_train_experiments as tool


@pytest.mark.parametrize("variant", tool.VARIANTS)
def test_variant_runs_forward_and_backward_on_cpu(variant):
    before = (pool_ops.launches, pool_ops.launches_fwd, brp_ops.launches, brp_ops.launches_bwd)
    step, inputs = tool.build_variant(variant, bs=2, size=8, device="cpu", seed=1)
    assert len(inputs) == 4
    for i in inputs[:2]:
        step(i)
    assert (pool_ops.launches, pool_ops.launches_fwd, brp_ops.launches,
            brp_ops.launches_bwd) == before


def test_jax_script_lists_the_same_variants():
    """The port's tool takes the variant names of scripts/stem_train_experiments.py."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "scripts" / "stem_train_experiments.py").read_text()
    block = re.search(r'choices=\[(.*?)\]', src, re.S).group(1)
    assert tuple(re.findall(r'"(\w+)"', block)) == tool.VARIANTS


def test_tool_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tool.run("pool")
    with pytest.raises(SystemExit, match="CUDA device"):
        tool.main(["brp"])
    with pytest.raises(ValueError, match="unknown variant"):
        tool.build_variant("nope", device="cpu")
