"""ssdx_torch.train.schedule against ssdx.train.schedule (CPU, f32).

* LR at every step: rtol 1e-6, plus atol 1e-7 * base_lr.  Both compute in
  float32 operation by operation, but XLA's and numpy's float32 cos differ
  by one ulp at some steps; near the end of the decay 1 + cos cancels and
  that ulp becomes a larger share of the LR (it is at most 0.5 * 6e-8 *
  base_lr in absolute terms).
* Parameters after 3 SGD steps with warmup (the first step's LR is 0) and
  weight decay, against the optax chain: atol 1e-6.
* ReduceOnPlateau: the same LR sequence on the same metric sequence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssdx.train import schedule as J
from ssdx_torch.train.schedule import (ReduceOnPlateau, build_optimizer, get_learning_rate,
                                       set_learning_rate, warmup_cosine_schedule)


@pytest.mark.parametrize("base_lr,warmup,total,min_lr", [
    (3e-3, 10, 50, 1e-6),
    (1e-2, 0, 40, 0.0),
    (3e-3, 35, 1050, 1e-6),  # the reference recipe at 7 steps per epoch
])
def test_warmup_cosine_matches_jax(base_lr, warmup, total, min_lr):
    ref_fn = J.warmup_cosine_schedule(base_lr, warmup, total, min_lr)
    got_fn = warmup_cosine_schedule(base_lr, warmup, total, min_lr)
    steps = range(total + 3)
    ref = np.array([float(ref_fn(s)) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7 * base_lr)
    if warmup:
        assert got[0] == 0.0


def test_sgd_steps_match_optax_chain():
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (3,), "scale": (5,)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    kw = dict(steps_per_epoch=2, max_epochs=4, warmup_epochs=1, base_lr=0.1,
              momentum=0.9, weight_decay=5e-3)

    tx, _ = J.build_optimizer(**kw)
    params = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in p0.items()}
    opt, sched = build_optimizer(list(tp.values()), **kw)
    lrs = []
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        lrs.append(get_learning_rate(opt))
        opt.step()
        sched.step()
    assert lrs[0] == 0.0 and lrs[1] > 0.0
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(params[k]), rtol=0,
                                   atol=1e-6)


def test_reduce_on_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.1, 3.2, 3.3, 3.4, 2.0, 2.5, 2.6]
    kw = dict(base_lr=0.1, factor=0.5, patience=2, threshold=1e-3, cooldown=1, min_lr=0.03)
    ref, got = J.ReduceOnPlateau(**kw), ReduceOnPlateau(**kw)
    seq_ref = [ref.step(m) for m in metrics]
    seq_got = [got.step(m) for m in metrics]
    assert seq_got == seq_ref
    assert min(seq_got) == 0.03 and seq_got[0] == 0.1  # reduced twice, floored

    opt, ctrl = build_optimizer([torch.nn.Parameter(torch.zeros(2))], steps_per_epoch=3,
                                base_lr=0.1, scheduler="plateau")
    assert isinstance(ctrl, ReduceOnPlateau) and get_learning_rate(opt) == pytest.approx(0.1)
    set_learning_rate(opt, 0.025)
    assert get_learning_rate(opt) == 0.025
    with pytest.raises(ValueError, match="scheduler"):
        build_optimizer([torch.nn.Parameter(torch.zeros(2))], 3, scheduler="step")
