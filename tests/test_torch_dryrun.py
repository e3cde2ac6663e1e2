"""The port's dry run (ssdx_torch/tools/dryrun.py) against __graft_entry__.py.

* ``dryrun_multichip(2)`` on the CPU at width 0.25: two gloo worker
  processes print the ok line, and both ranks end with bit-identical
  parameters (sha256 over the state dict).
* The first step's loss on ``__graft_entry__``'s synthetic batch (B = 2,
  G = 4, ``np.random.default_rng(0)``), which the two ranks compute one image
  each, equals the JAX package's train-step loss on the whole batch from the
  same initial variables within 1e-4 relative (f32 on the CPU; the step-loss
  agreement of tests/test_torch_train_step.py).
* ``entry(device="cpu", width_mult=0.25)``: its forward on zeros and on
  seeded images equals the JAX ``SSD300(num_classes=6, width_mult=0.25)``
  forward on the same weights (carried across by ssdx_torch/weights.py)
  within 1e-3 of the largest output, tests/test_torch_model.py's limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import priors as JP
from ssdx.model import SSD300 as JaxSSD300
from ssdx.train import schedule as JS
from ssdx.train import step as JT
from ssdx_torch.model import init_variables
from ssdx_torch.tools import dryrun
from ssdx_torch.weights import variables_from_torch

WM = 0.25


@pytest.fixture(scope="module")
def two_ranks():
    lines = []
    result = dryrun.dryrun_multichip(2, device="cpu", width_mult=WM, timeout=300,
                                     log=lines.append)
    return result, lines


def test_two_ranks_print_ok_and_agree(two_ranks):
    result, lines = two_ranks
    assert lines == [dryrun.ok_line(2, result)]
    assert lines[0].startswith(f"dryrun_multichip(2): ok, loss={result['loss']:.4f}, "
                               "infer bs=8 dets ok")
    assert result["backend"] == "gloo" and len(result["ranks"]) == 2
    a, b = result["ranks"]
    assert a["params"] == b["params"] and len(a["params"]) == 64
    assert a["loss"] == b["loss"] and a["loader_loss"] == b["loader_loss"]
    assert a["step"] == b["step"] == 2
    assert a["boxes"] == b["boxes"] == [8, 100, 4]
    assert np.isfinite(a["loader_loss"])


def _graft_batch(B, G=4):
    """__graft_entry__.py's synthetic batch, drawn in its order."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(0.1, 0.6, (B, G, 2)).astype(np.float32)
    sz = rng.uniform(0.1, 0.3, (B, G, 2)).astype(np.float32)
    return JT.Batch(
        images=jnp.asarray(rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)),
        gt_boxes=jnp.asarray(np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1)),
        gt_labels=jnp.asarray(rng.integers(0, 5, (B, G)).astype(np.int32)),
        gt_valid=jnp.asarray(np.ones((B, G), bool)),
    )


def test_first_loss_equals_jax_on_the_whole_batch(two_ranks):
    result, _ = two_ranks
    variables = init_variables(6, 0, WM)
    model = JaxSSD300(num_classes=6, width_mult=WM)
    tx, _ = JS.build_optimizer(steps_per_epoch=10, max_epochs=1, warmup_epochs=0)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params))
    pri = JP.create_priors()
    step = JT.make_train_step(model, tx, jnp.asarray(pri), jnp.asarray(JP.priors_xyxy(pri)),
                              iou_thresh=0.4)
    _, metrics = step(state, _graft_batch(2))
    ref = float(metrics["loss"])
    assert abs(result["loss"] - ref) <= 1e-4 * abs(ref), (result["loss"], ref)


def test_entry_forward_equals_jax():
    fn, (model, images) = dryrun.entry(device="cpu", width_mult=WM)
    assert tuple(images.shape) == (8, 300, 300, 3) and not model.training
    variables = variables_from_torch(model)
    jmodel = JaxSSD300(num_classes=6, width_mult=WM)
    x = np.random.default_rng(3).normal(0, 1, (2, 300, 300, 3)).astype(np.float32)
    for inp in (images[:2].numpy(), x):
        loc, cls = fn(model, torch.as_tensor(inp))
        rloc, rcls = jmodel.apply(variables, jnp.asarray(inp), train=False)
        for got, ref in ((loc, rloc), (cls, rcls)):
            ref = np.asarray(ref)
            assert got.shape == ref.shape == (2, 8732, ref.shape[-1])
            assert np.abs(got.numpy() - ref).max() <= 1e-3 * max(np.abs(ref).max(), 1e-6)
