"""The port's directory-format checkpoint (ssdx_torch/train/sharded_checkpoint.py),
as tests/test_sharded_checkpoint.py holds the JAX package's.

* Two gloo processes (tests/torch_dist.py, job ``checkpoint``) save through
  ``save_checkpoint(mesh=)``, which must pick the directory format; both
  restore and find the arrays bit for bit, their own python and numpy RNG,
  rank 0's torch generator state, the epoch, best metric and loss history;
  then a stale ``.staging`` directory from a crashed save is cleared by the
  next save of the same tag.
* One process loads a directory through ``load_checkpoint`` and a file-format
  save replaces a directory under the same tag.
* The arrays are the same numbers the single-file format stores.
"""
import pickle

import numpy as np
import pytest
import torch

import torch_dist as D
from ssdx_torch.model import init_variables
from ssdx_torch.train.checkpoint import load_checkpoint, save_checkpoint
from ssdx_torch.train.sharded_checkpoint import save_checkpoint_sharded


@pytest.fixture(scope="module")
def variables():
    return init_variables(6, seed=1, width_mult=D.WM)


def test_two_rank_roundtrip_with_per_rank_rng_and_stale_staging(variables, tmp_path):
    (tmp_path / "variables.pkl").write_bytes(pickle.dumps(variables))
    D.run_ranks(["checkpoint"], tmp_path, timeout=300)
    ckpt = tmp_path / "ckpt" / "last.ckpt"
    files = sorted(p.name for p in ckpt.iterdir())
    assert files == ["arrays.pkl", "host_meta_p0.pkl", "host_meta_p1.pkl"]
    assert D.load(tmp_path, "checkpoint", 0)["files"] == files
    meta0, meta1 = (pickle.loads((ckpt / f"host_meta_p{r}.pkl").read_bytes()) for r in (0, 1))
    assert meta0["epoch"] == 4 and "epoch" not in meta1
    assert meta0["rng_state"]["torch"] is not None and "torch" not in meta1["rng_state"]
    assert meta0["rng_state"]["python"] != meta1["rng_state"]["python"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["last.ckpt"]


def _step_once(state):
    for p in state.model.parameters():
        p.grad = torch.full_like(p, 1e-3)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def test_single_process_dir_dispatch(variables, tmp_path):
    state = D._state(variables, None)
    _step_once(state)  # momentum buffers and a scheduler that has moved
    path = save_checkpoint_sharded(epoch=1, state=state, loss_dict={"k": [1]}, best_metric=0.5,
                                   outdir=tmp_path, tag="best")
    assert path.is_dir() and path.name == "best.ckpt"
    fresh = D._state(D.init_tree(variables, 0.0), None)
    got, start_epoch, best, loss_dict = load_checkpoint(path, fresh)
    assert got is fresh and (start_epoch, best, loss_dict) == (2, 0.5, {"k": [1]})
    assert fresh.step == 1
    for a, b in zip(state.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for k, v in sa["state"].items():
        assert torch.equal(v["momentum_buffer"], sb["state"][k]["momentum_buffer"])
    assert state.scheduler.state_dict() == fresh.scheduler.state_dict()


def test_both_formats_hold_the_same_arrays_and_replace_each_other(variables, tmp_path):
    state = D._state(variables, None)
    d = save_checkpoint_sharded(epoch=0, state=state, loss_dict=None, outdir=tmp_path, tag="t")
    arrays = pickle.loads((d / "arrays.pkl").read_bytes())
    f = save_checkpoint(epoch=0, state=state, loss_dict=None, outdir=tmp_path, tag="t")
    assert f == tmp_path / "t.ckpt" and f.is_file()  # the file took the directory's place
    single = pickle.loads(f.read_bytes())
    assert arrays["format"] == single["format"] == 2
    fa, fs = D.flat(arrays["params"]), D.flat(single["params"])
    assert sorted(fa) == sorted(fs)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fs[k])
    d2 = save_checkpoint_sharded(epoch=2, state=state, loss_dict=None, outdir=tmp_path, tag="t")
    assert d2.is_dir() and load_checkpoint(d2, state)[1] == 3


def test_restore_rng_can_be_left_alone(variables, tmp_path):
    import random

    state = D._state(variables, None)
    path = save_checkpoint_sharded(epoch=0, state=state, loss_dict=None, outdir=tmp_path)
    random.seed(5)
    before = random.getstate()
    load_checkpoint(path, state, restore_rng=False)
    assert random.getstate() == before
    load_checkpoint(path, state)
    assert random.getstate() != before
