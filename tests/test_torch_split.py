"""The port's stratified group split (numpy) against the JAX package's, which
takes its folds from scikit-learn's StratifiedGroupKFold: the same train and
test file lists, in the same order, for seeded annotation frames; the same
errors and warning; and the port's training command imports and splits on
an interpreter where scikit-learn cannot be imported.
"""
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import StratifiedGroupKFold

from ssdx.data.split import stratified_group_split as jax_split
from ssdx_torch.data import synth
from ssdx_torch.data.split import stratified_group_kfold_test_mask, stratified_group_split

from torch_parity import REPO

CLASSES = ["biker", "car", "pedestrian", "trafficLight", "truck"]


def annotation_frame(seed, n_files=60):
    """Groups of 1-6 rows, classes drawn with unbalanced weights."""
    rng = np.random.default_rng(seed)
    p = np.array([0.05, 0.5, 0.25, 0.05, 0.15])
    rows = []
    for f in range(n_files):
        for _ in range(int(rng.integers(1, 7))):
            rows.append({"filename": f"img_{f:04d}.jpg",
                         "class": CLASSES[rng.choice(5, p=p)]})
    return pd.DataFrame(rows)


@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.33])
@pytest.mark.parametrize("seed", range(20))
def test_split_equals_scikit_learn(seed, test_size):
    df = annotation_frame(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # rare classes: both warn alike
        want = jax_split(df, test_size=test_size, rand_state=seed)
        got = stratified_group_split(df, test_size=test_size, rand_state=seed)
    assert got == want
    assert not set(got[0]) & set(got[1]) and len(got[0]) + len(got[1]) == 60


@pytest.fixture(scope="module")
def synth_frame(tmp_path_factory):
    return synth.generate_dataset(tmp_path_factory.mktemp("synth_split"), 40, seed=7, size=96)


@pytest.mark.parametrize("seed", [0, 724, 2**31 - 1])
def test_split_equals_scikit_learn_on_synthdrive(synth_frame, seed):
    for test_size in (0.2, 0.25, 0.33):
        assert (stratified_group_split(synth_frame, test_size, seed)
                == jax_split(synth_frame, test_size, seed))


def test_every_fold_mask_is_the_first_fold_of_scikit_learn():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, 300)
    groups = rng.integers(0, 70, 300)
    for k in (2, 3, 5):
        train, test = next(StratifiedGroupKFold(k, shuffle=True, random_state=11)
                           .split(np.zeros(300), y, groups))
        mask = stratified_group_kfold_test_mask(y, groups, k, 11)
        assert np.array_equal(np.flatnonzero(mask), test)
        assert np.array_equal(np.flatnonzero(~mask), train)


def _both_raise(y, groups, n_splits):
    with pytest.raises(ValueError) as theirs:
        next(StratifiedGroupKFold(n_splits, shuffle=True, random_state=0)
             .split(np.zeros(len(y)), y, groups))
    with pytest.raises(ValueError) as ours:
        stratified_group_kfold_test_mask(y, groups, n_splits, 0)
    assert str(ours.value) == str(theirs.value)


def test_errors_match_scikit_learn():
    groups = np.arange(12) // 2
    _both_raise(np.linspace(0.1, 1.3, 12), groups, 3)  # continuous target
    _both_raise(np.array([0, 0, 1, 1, 2, 2] * 2), groups, 5)  # n_splits > every class
    _both_raise(np.array([0, 1] * 6), np.arange(12) // 6, 3)  # more splits than groups


def test_warning_for_a_small_class_matches_scikit_learn():
    y = np.array([0] * 10 + [1] * 10 + [2])
    groups = np.arange(21)
    with pytest.warns(UserWarning) as theirs:
        next(StratifiedGroupKFold(4, shuffle=True, random_state=3)
             .split(np.zeros(21), y, groups))
    with pytest.warns(UserWarning) as ours:
        mask = stratified_group_kfold_test_mask(y, groups, 4, 3)
    assert [str(w.message) for w in ours] == [str(w.message) for w in theirs]
    assert "only 1 members" in str(ours[0].message) and mask.any()


def test_training_command_splits_without_scikit_learn(tmp_path):
    df = annotation_frame(3)
    df.to_csv(tmp_path / "ann.csv", index=False)
    code = (
        "import sys; sys.modules['sklearn'] = None\n"
        "import pandas as pd\n"
        "import ssdx_torch.train.run\n"
        "from ssdx_torch.data.split import stratified_group_split\n"
        f"df = pd.read_csv({str(tmp_path / 'ann.csv')!r})\n"
        "tr, te = stratified_group_split(df, 0.25, 724)\n"
        "print(','.join(tr)); print(','.join(te))\n"
        "assert 'sklearn.model_selection' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    train, test = (line.split(",") for line in out.stdout.strip().splitlines())
    assert (train, test) == jax_split(df, 0.25, 724)
