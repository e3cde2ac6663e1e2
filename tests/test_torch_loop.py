"""The port's epoch loop, checkpoints and mAP against the JAX package (CPU).

* ``MeanAP``: the port's numpy copy against ``ssdx.eval.map.MeanAP`` on the
  same seeded detections: every key equal within 1e-6 (both are float64
  numpy; the JAX package matches through its C++ kernel, a private build of
  this module (``torch_parity.jax_native_private``), the port through the
  numpy loop).
* ``merge_results`` on the cases of tests/test_e2e_train.py.
* ``fit`` -> ``last.ckpt`` -> ``load_checkpoint`` -> resume, on in-memory
  batches, as tests/test_e2e_train.py does with the JAX loop.
* ``save_params`` read back by ``ssdx.train.checkpoint.load_params``: equal
  arrays.
"""
import numpy as np
import pytest
import torch

from ssdx.eval.map import MeanAP as JaxMeanAP
from ssdx.train.checkpoint import load_params as jax_load_params
from ssdx_torch import priors as P
from ssdx_torch.eval.map import MeanAP
from ssdx_torch.model import SSD300, init_variables
from ssdx_torch.train.checkpoint import load_checkpoint, save_params
from ssdx_torch.train.loop import fit, merge_results
from ssdx_torch.train.schedule import build_optimizer
from ssdx_torch.train.step import Batch, create_train_state, make_eval_step, make_train_step
from ssdx_torch.weights import variables_from_torch
from torch_parity import flatten, jax_native_private  # noqa: F401 (autouse fixture)

PRI = P.create_priors()
PRI_XYXY = P.priors_xyxy(PRI)
WM = 0.125


def _map_data(seed, n_img=24):
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for _ in range(n_img):
        ng = int(rng.integers(0, 6))
        lo = rng.uniform(0, 250, (ng, 2))
        gt = np.concatenate([lo, lo + rng.uniform(8, 120, (ng, 2))], 1)
        gl = rng.integers(0, 5, ng)
        # detections: jittered GT plus clutter
        jit = gt + rng.normal(0, 6, gt.shape)
        lo = rng.uniform(0, 250, (4, 2))
        clutter = np.concatenate([lo, lo + rng.uniform(8, 80, (4, 2))], 1)
        boxes = np.concatenate([jit, clutter])
        labels = np.concatenate([np.where(rng.random(ng) < 0.8, gl, rng.integers(0, 5, ng)),
                                 rng.integers(0, 5, 4)])
        preds.append({"boxes": boxes.astype(np.float32),
                      "scores": rng.uniform(0.05, 1, len(boxes)).astype(np.float32),
                      "labels": labels})
        targets.append({"boxes": gt.astype(np.float32), "labels": gl})
    return preds, targets


@pytest.mark.parametrize("seed", [0, 1])
def test_mean_ap_matches_jax(seed):
    preds, targets = _map_data(seed)
    ref, got = JaxMeanAP(0.5), MeanAP(0.5)
    for i in range(0, len(preds), 8):  # several update calls, as the loop makes
        ref.update(preds[i:i + 8], targets[i:i + 8])
        got.update(preds[i:i + 8], targets[i:i + 8])
    r, g = ref.compute(), got.compute()
    assert sorted(r) == sorted(g)
    assert 0.0 < g["map_50"] < 1.0
    for k in r:
        np.testing.assert_allclose(np.asarray(g[k]), np.asarray(r[k]), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_merge_results_contract():
    d1 = {"a": [1, 2], "epochs": [2]}
    d2 = {"a": [3], "epochs": [5]}
    out = merge_results(d1, d2)
    assert out["a"] == [1, 2, 3]
    assert out["epochs"] == [5]
    with pytest.raises(KeyError):
        merge_results({"a": [1]}, {"b": [2]})


def test_merge_results_recursive_and_sets():
    d1 = {"meta": {"hist": [1], "note": "x"}, "tags": {"a", "b"}, "epochs": [1]}
    d2 = {"meta": {"hist": [2], "note": "y"}, "tags": {"b", "c"}, "epochs": [2]}
    out = merge_results(d1, d2)
    assert out["meta"]["hist"] == [1, 2]
    assert out["meta"]["note"] == ("x", "y")  # scalar leaves keep both
    assert sorted(out["tags"]) == ["a", "b", "c"]
    d3 = {"meta": {"hist": [3], "note": "z"}, "tags": {"d"}, "epochs": [3]}
    out2 = merge_results({**out, "meta": {"hist": out["meta"]["hist"], "note": "y"}}, d3)
    assert out2["meta"]["hist"] == [1, 2, 3]
    out3 = merge_results({"m": {"a": 1}, "epochs": [0]}, {"m": {"a": 2, "b": 3}, "epochs": [1]})
    assert out3["m"] == {"a": 2, "b": 3}


class _Loaded:
    """A wrap-padded tail batch: ``count`` real images."""

    def __init__(self, batch, count):
        self.batch, self.count = batch, count


def _batches(seed, n=2, B=2, G=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lo = rng.uniform(0.1, 0.5, (B, G, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (B, G, 2))], -1)
        out.append(Batch(rng.normal(0, 1, (B, 300, 300, 3)).astype(np.float32),
                         boxes.astype(np.float32), rng.integers(0, 2, (B, G)).astype(np.int32),
                         np.ones((B, G), bool)))
    return out


def _build(epochs=2):
    model = SSD300(3, width_mult=WM)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=2, max_epochs=epochs,
                                 warmup_epochs=0, base_lr=1e-3)
    state = create_train_state(model, opt, sched, init_variables(3, seed=0, width_mult=WM))
    train_step = make_train_step(model, PRI, PRI_XYXY, iou_thresh=0.4)
    eval_step = make_eval_step(model, PRI, PRI_XYXY, iou_thresh=0.4, score_thresh=0.2,
                               nms_thresh=0.3, max_per_img=10)
    return state, train_step, eval_step


def test_fit_checkpoint_resume(tmp_path):
    save_dir = tmp_path / "ckpts"
    train = _batches(0)
    val = [train[0], _Loaded(train[1], 1)]
    state, train_step, eval_step = _build()
    logs = []
    state, results = fit(train_step, eval_step, state, lambda: train, lambda: val, epochs=2,
                         save_model=True, save_dir=save_dir, timing=True, log=logs.append)

    for k in ["train_loss", "train_loss_loc", "train_loss_conf", "test_loss",
              "test_loss_loc", "test_loss_conf", "mAP", "epochs",
              "training timing", "testing timing"]:
        assert k in results
    assert len(results["train_loss"]) == 2
    assert results["epochs"] == [2]
    assert all(np.isfinite(results["train_loss"]))
    assert len(logs) == 2 and "mAP" in logs[0]
    assert (save_dir / "last.ckpt").exists() and state.step == 4

    # ---- resume: a fresh state from the checkpoint, one more epoch ----
    fresh, train_step2, eval_step2 = _build()
    restored, start_epoch, best, loss_dict = load_checkpoint(save_dir / "last.ckpt", fresh)
    assert start_epoch == 2  # 2 epochs completed -> next epoch index 2
    assert restored.step == 4 and np.isfinite(best)
    assert len(loss_dict["train_loss"]) == 2
    a, b = flatten(variables_from_torch(state.model)), flatten(variables_from_torch(fresh.model))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch == 4
    m_old = state.optimizer.state_dict()["state"]
    m_new = restored.optimizer.state_dict()["state"]
    for i in m_old:
        torch.testing.assert_close(m_new[i]["momentum_buffer"], m_old[i]["momentum_buffer"])

    state2, results2 = fit(train_step2, eval_step2, restored, lambda: train, lambda: val,
                           epochs=1, save_model=False, past_train_dict=loss_dict,
                           log=lambda s: None)
    assert len(results2["train_loss"]) == 3  # merged 2 + 1
    assert results2["epochs"] == [1 + loss_dict["epochs"][0]]


def test_save_params_loads_in_jax_package(tmp_path):
    model = SSD300(6, width_mult=WM)
    opt, sched = build_optimizer(model.parameters(), steps_per_epoch=2)
    state = create_train_state(model, opt, sched, init_variables(6, seed=1, width_mult=WM))
    v = variables_from_torch(state.model)
    path = save_params(v["params"], v["batch_stats"], tmp_path / "w.pkl")
    back = jax_load_params(path)
    a, b = flatten(v), flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
