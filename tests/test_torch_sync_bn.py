"""Sync-BN in the port: two ranks, each with half of the batch, compute the
whole batch's BatchNorm statistics.

Two gloo processes on the CPU (tests/torch_dist.py), f32:

* ``width_mult=0.25``, 4 + 4 images, one train-mode forward: the updated
  running statistics equal the one-process 8-image forward to ``atol=1e-5,
  rtol=1e-4`` (the limits of tests/test_sync_bn.py for the JAX package: the
  two sum the same values in another order), and equal the JAX package's on
  the same images within 1e-4 of each statistic's largest magnitude (the
  limit of tests/test_torch_model.py for train mode);
* the plain version of kernel B3 with a mesh at two ranks (1 + 1 images)
  against the plain B3 on the whole batch, on two images of different
  scale: ``p`` and the four statistics within 1e-4 of the largest magnitude,
  and the gradients after the sum over ranks within 1e-2 of theirs.  The
  gradients' limit is looser because the backward decides by comparisons
  (ReLU masks, pool maxima): a statistic that differs in its last bit flips
  a few of 11.5 million decisions, each worth one pixel's whole
  contribution.  Swapping the two images inside one process moves the
  gradients by up to 1.1e-3 in the same way, while per-shard statistics
  (the fault this test is for) move them by 0.4 to 0.75.  Each rank returns
  its local dgamma, dbeta, dW1 and dW2 (the train step's gradient
  all-reduce adds them), so the local ones must differ from the whole
  batch's.
"""
import pickle

import numpy as np
import pytest
import torch

import torch_dist as D
from ssdx.model import SSD300 as JaxSSD300
from ssdx_torch.model import SSD300
from ssdx_torch.ops.stem_train import stem_train_ref
from ssdx_torch.weights import state_dict_from_jax, variables_from_torch
from torch_parity import flatten, random_variables


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sync_bn")
    variables = random_variables(D.WM, seed=1)
    (d / "variables.pkl").write_bytes(pickle.dumps(variables))
    D.run_ranks(["sync_bn", "stem_train"], d)
    return variables, [{j: D.load(d, j, r) for j in ("sync_bn", "stem_train")} for r in range(2)]


def test_two_rank_stats_equal_one_process(ranks):
    variables, (r0, r1) = ranks
    model = SSD300(6, width_mult=D.WM)
    model.load_state_dict(state_dict_from_jax(variables, False))
    with torch.no_grad():
        loc, _ = model(torch.as_tensor(D.images(8)), train=True)
    want = flatten(variables_from_torch(model)["batch_stats"])
    assert sorted(want) == sorted(r0["sync_bn"]["stats"])
    for k, w in want.items():
        for r in (r0, r1):
            np.testing.assert_allclose(r["sync_bn"]["stats"][k], w, atol=1e-5, rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_array_equal(r0["sync_bn"]["stats"][k], r1["sync_bn"]["stats"][k])
    got = np.concatenate([r0["sync_bn"]["loc"], r1["sync_bn"]["loc"]])
    assert np.abs(got - loc.numpy()).max() <= 1e-4 * np.abs(loc.numpy()).max()


def test_two_rank_stats_equal_jax(ranks):
    variables, (r0, _) = ranks
    _, mutated = JaxSSD300(num_classes=6, width_mult=D.WM).apply(
        variables, D.images(8), train=True, mutable=["batch_stats"])
    ref = flatten(mutated["batch_stats"])
    assert sorted(ref) == sorted(r0["sync_bn"]["stats"])
    for k, w in ref.items():
        err = np.abs(r0["sync_bn"]["stats"][k] - w).max() / np.abs(w).max()
        assert err < 1e-4, (k, err)


def test_plain_b3_with_mesh_equals_whole_batch(ranks):
    _, (r0, r1) = ranks
    x, args, dp = D.stem_inputs()
    ps = [torch.as_tensor(a).requires_grad_() for a in args]
    out = stem_train_ref(torch.as_tensor(x), *ps, dtype=torch.float32)
    torch.autograd.backward(out[0], torch.as_tensor(dp))
    rel = lambda got, ref: float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6))

    p = np.concatenate([r0["stem_train"]["out"][0], r1["stem_train"]["out"][0]])
    assert rel(p, out[0].detach().numpy()) < 1e-4
    for i in range(1, 5):  # mean1, var1, mean2, var2: global on both ranks
        for r in (r0, r1):
            assert rel(r["stem_train"]["out"][i], out[i].numpy()) < 1e-4, i
    local_differs = 0
    for i, q in enumerate(ps):
        g0, g1, ref = r0["stem_train"]["grads"][i], r1["stem_train"]["grads"][i], q.grad.numpy()
        if not ref.any():  # db1, db2: exact zeros everywhere
            assert not g0.any() and not g1.any()
            continue
        assert rel(g0 + g1, ref) < 1e-2, i
        local_differs += rel(g0, ref) > 0.1
    assert local_differs == 6  # dw1, dg1, dbe1, dw2, dg2, dbe2 are per-rank shares
