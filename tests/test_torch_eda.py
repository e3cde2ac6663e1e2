"""ssdx_torch.data.eda against ssdx.data.eda on the fixture of
tests/test_eda.py.  ``dataset_stats`` reads the CSV alone and must give the
same dict.  ``augmented_area_stats`` draws through the port's augmentation,
whose random numbers are a torch generator's and not ``jax.random``'s, so the
two are compared as distributions: the same number of batches sampled, and
medians that both show the crop's zoom-in (at least the raw 0.0625 of the
fixture's boxes less the sanitizer's cut, 0.02, as the JAX test asks)."""
import json

import numpy as np
import pandas as pd
import pytest

from ssdx.data import eda as ref
from ssdx.data.dataset import DetectionDataset as RefDataset
from ssdx_torch.data import eda as port
from ssdx_torch.data.dataset import DetectionDataset


@pytest.fixture(scope="module")
def stats_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("eda")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        name = f"e{i:02d}.jpg"
        cv2.imwrite(str(d / name), rng.integers(0, 255, (64, 64, 3), np.uint8))
        if i == 11:
            rows.append(dict(filename=name, width=64, height=64, **{"class": "empty"},
                             xmin=0, ymin=0, xmax=0, ymax=0))
            continue
        for _ in range(2):
            rows.append(dict(filename=name, width=64, height=64,
                             **{"class": "car" if i % 2 else "truck"},
                             xmin=4, ymin=4, xmax=20, ymax=20))
    pd.DataFrame(rows).to_csv(d / "ann.csv", index=False)
    return d


def test_dataset_stats_equals_the_jax_package(stats_dir):
    out = port.dataset_stats(DetectionDataset(stats_dir))
    assert out["n_images"] == 12 and out["n_boxes"] == 22
    assert out["class_counts"] == {"car": 10, "truck": 12}
    assert out["objects_per_image"]["empty_images"] == 1
    assert out["objects_per_image"]["max"] == 2
    assert np.isclose(out["area_frac"]["median"], 0.0625, atol=1e-4)
    assert out == ref.dataset_stats(RefDataset(stats_dir))


def test_augmented_area_stats(stats_dir):
    out = port.augmented_area_stats(DetectionDataset(stats_dir), n_batches=2, batch_size=4,
                                    device="cpu")
    want = ref.augmented_area_stats(RefDataset(stats_dir), n_batches=2, batch_size=4)
    assert set(out) == set(want)
    assert 0 < out["n_boxes_sampled"] <= 16 and 0 < want["n_boxes_sampled"] <= 16
    assert out["median"] >= 0.02 and want["median"] >= 0.02
    assert out["p90"] >= out["median"] and 0.0 < out["mean"] <= 1.0


def test_command_prints_json(stats_dir, capsys):
    port.main([str(stats_dir), "--measure-augment", "--cpu"])
    out = json.loads(capsys.readouterr().out)
    # 12 images make no whole batch of the command's 16: nothing is sampled
    assert out["n_images"] == 12 and out["augmented_area_frac"]["n_boxes_sampled"] == 0
