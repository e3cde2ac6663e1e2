"""The port's train and eval steps against the JAX package's (CPU, f32).

* Two train steps at width_mult=0.25, B=2, from the same variables: each
  step's loss within rtol 1e-4, and every parameter and running statistic
  after them within 1e-4 L2-relative (norm floor 1e-3, as
  tests/test_train_step_fused_stem.py), at base_lr 1e-4.  XLA:CPU and
  oneDNN sum the convs in different orders, and the JAX model's own
  gradient moves by about 1 % L2 when its input is perturbed by 1e-7
  relative (train-mode BN on maps down to 1x1 at B=2), so after the first
  update the two runs follow gradients that differ at the percent level;
  the small LR keeps that well inside 1e-4 of the parameters.
* The first update at base_lr 1e-2 directly: within 2e-2 L2-relative of
  the JAX update, the gradient noise just described, for every parameter
  but the conv biases under a BN (their gradient is rounding noise).
* Full width, B=1: the port's fused-stem step (the plain version of kernel
  B3 on the CPU) against its own unfused step.  Loss within 1e-3 relative,
  parameters within 1e-2 L2-relative, stem conv biases left out (the fused
  op returns their analytically exact zero gradient where autodiff returns
  noise), running statistics within 1e-4 of their max.  The unfused step is
  chained to the JAX package by the first test and the plain B3 by
  tests/test_torch_stem_train.py.
* The eval step with a wrap-padded tail (img_valid), against the JAX eval
  step: losses within rtol 1e-4, the same detections.
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
from ssdx_torch import priors as P
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_eval_step, make_train_step
from ssdx_torch.weights import variables_from_torch
from torch_parity import flatten, random_variables

PRI = P.create_priors()
PRI_XYXY = P.priors_xyxy(PRI)
JPRI = jnp.asarray(JP.create_priors())
JPRI_XYXY = jnp.asarray(JP.priors_xyxy(np.asarray(JPRI)))
OPT = dict(steps_per_epoch=10, max_epochs=2, warmup_epochs=0, base_lr=1e-2)


def _batch(rng, B=2, G=8, n_valid=3):
    images = rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32)
    lo = rng.uniform(0.1, 0.5, (B, G, 2))
    sz = rng.uniform(0.1, 0.4, (B, G, 2))
    boxes = np.concatenate([lo, np.minimum(lo + sz, 1.0)], -1).astype(np.float32)
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[:, :n_valid] = True
    return Batch(images, boxes, labels, valid)


def _jax_state(tx, variables):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                         opt_state=tx.init(params))


def _port_state(variables, width_mult, **opt):
    model = SSD300(6, width_mult=width_mult)
    optimizer, sched = build_optimizer(model.parameters(), **opt)
    return create_train_state(model, optimizer, sched, variables)


def _l2_rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-3)


def _run_both(variables, batch, n_steps, wm=0.25, **opt):
    """n_steps of the JAX and the port's unfused train step; returns both
    JAX-layout trees after them."""
    tx, _ = JS.build_optimizer(**opt)
    jstep = JT.make_train_step(JaxSSD300(num_classes=6, width_mult=wm), tx, JPRI, JPRI_XYXY,
                               iou_thresh=0.4, fused_stem=False)
    jstate = _jax_state(tx, variables)
    jb = JT.Batch(*(jnp.asarray(t) for t in batch))

    state = _port_state(variables, wm, **opt)
    step = make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4, fused_stem=False)
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, batch)
        for k in ("loss", "loss_loc", "loss_conf"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == n_steps and int(jstate.step) == n_steps
    ref = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = flatten(variables_from_torch(state.model))
    assert sorted(ref) == sorted(got)
    return ref, got


def test_train_steps_match_jax_f32():
    variables = random_variables(0.25, seed=3)
    ref, got = _run_both(variables, _batch(np.random.default_rng(0)), 2,
                         **dict(OPT, base_lr=1e-4))
    for k in ref:
        rel = _l2_rel(ref[k].ravel(), got[k].ravel())
        assert rel < 1e-4, (k, rel)


def test_first_update_matches_jax_f32():
    variables = random_variables(0.25, seed=3)
    ref, got = _run_both(variables, _batch(np.random.default_rng(0)), 1, **OPT)
    p0 = flatten(variables)
    checked = 0
    for k in ref:
        layer = k.split("/")[2]
        if k.endswith("Conv_0/bias") and f"/params/{layer}/BatchNorm_0/scale" in ref:
            continue
        du_ref, du_got = ref[k] - p0[k], got[k] - p0[k]
        rel = np.linalg.norm(du_ref - du_got) / max(np.linalg.norm(du_ref), 1e-12)
        assert rel < 2e-2, (k, rel)
        checked += 1
    assert checked > 80


def test_fused_stem_step_matches_unfused_full_width_f32():
    variables = init_variables(6, seed=0)
    batch = _batch(np.random.default_rng(4), B=1, G=4, n_valid=4)
    out = {}
    for fused in (False, True):
        state = _port_state(variables, 1.0, **OPT)
        step = make_train_step(state.model, PRI, PRI_XYXY, iou_thresh=0.4, fused_stem=fused)
        state, m = step(state, batch)
        out[fused] = (float(m["loss"]), flatten(variables_from_torch(state.model)))
    (la, va), (lb, vb) = out[False], out[True]
    assert abs(la - lb) < 1e-3 * max(1.0, abs(la)), (la, lb)
    for k in va:
        if k.startswith("/params/ConvBNRelu_0/Conv_0/bias") or \
                k.startswith("/params/ConvBNRelu_1/Conv_0/bias"):
            continue
        if k.startswith("/batch_stats"):
            rel = np.abs(va[k] - vb[k]).max() / (np.abs(va[k]).max() + 1e-6)
            assert rel < 1e-4, (k, rel)
        else:
            assert _l2_rel(va[k].ravel(), vb[k].ravel()) < 1e-2, k


def test_fused_stem_switch():
    model = SSD300(6, width_mult=0.25)
    with pytest.raises(ValueError, match="full-width"):
        make_train_step(model, PRI, PRI_XYXY, fused_stem=True)
    make_train_step(model, PRI, PRI_XYXY)  # None: off on the CPU, no error


def test_eval_step_matches_jax_with_padded_tail():
    wm = 0.25
    variables = random_variables(wm, seed=5)
    batch = _batch(np.random.default_rng(6), B=4)
    img_valid = np.array([True, True, True, False])
    kw = dict(iou_thresh=0.4, score_thresh=0.05, nms_thresh=0.5, max_per_img=50)

    tx, _ = JS.build_optimizer(**OPT)
    jev = JT.make_eval_step(JaxSSD300(num_classes=6, width_mult=wm), JPRI, JPRI_XYXY, **kw)
    jm, jdet = jev(_jax_state(tx, variables), JT.Batch(*(jnp.asarray(t) for t in batch)),
                   jnp.asarray(img_valid))

    state = _port_state(variables, wm, **OPT)
    ev = make_eval_step(state.model, PRI, PRI_XYXY, **kw)
    m, det = ev(state, batch, img_valid)
    for k in ("loss", "loss_loc", "loss_conf"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)

    valid = np.asarray(jdet.valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(det.valid.numpy(), valid)
    np.testing.assert_array_equal(det.labels.numpy()[valid], np.asarray(jdet.labels)[valid])
    np.testing.assert_allclose(det.scores.numpy()[valid], np.asarray(jdet.scores)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(det.boxes.numpy()[valid], np.asarray(jdet.boxes)[valid],
                               rtol=0, atol=0.05)
