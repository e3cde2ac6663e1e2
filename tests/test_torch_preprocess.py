"""ssdx_torch.data.preprocess against ssdx.data.preprocess on the fixture of
tests/test_preprocess.py: the same frames, the same split, the same files."""
import numpy as np
import pandas as pd
import pytest

from ssdx.data import preprocess as ref
from ssdx_torch.data import preprocess as port


@pytest.fixture()
def export_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    rows = []
    classes = ["car", "trafficLight-Red", "trafficLight-GreenLeft", "pedestrian"]
    for i in range(30):
        name = f"f{i:03d}.jpg"
        cv2.imwrite(str(tmp_path / name), rng.integers(0, 255, (32, 32, 3), np.uint8))
        if i < 24:  # the last 6 images are left unannotated
            rows.append(dict(filename=name, width=512, height=512,
                             **{"class": classes[i % 4]}, xmin=1, ymin=1, xmax=20, ymax=20))
    pd.DataFrame(rows).to_csv(tmp_path / "_annotations.csv", index=False)
    return tmp_path


def test_collapse_traffic_lights():
    df = pd.DataFrame({"class": ["trafficLight-Red", "trafficLightGreen", "car"]})
    out = port.collapse_traffic_lights(df)
    assert out["class"].tolist() == ["trafficLight", "trafficLight", "car"]
    pd.testing.assert_frame_equal(out, ref.collapse_traffic_lights(df))
    assert df["class"].tolist()[0] == "trafficLight-Red"  # the input is left alone


def test_add_empty_rows(export_dir):
    df = pd.read_csv(export_dir / "_annotations.csv")
    out = port.add_empty_rows(df, export_dir)
    empties = out[out["class"] == "empty"]
    assert len(empties) == 6
    assert (empties[["xmin", "ymin", "xmax", "ymax"]].to_numpy() == 0).all()
    assert (empties["width"] == 512).all()
    pd.testing.assert_frame_equal(out, ref.add_empty_rows(df, export_dir))


@pytest.mark.parametrize("seed", [724, 1])
def test_split_equals_the_jax_package(export_dir, seed):
    df = port.add_empty_rows(
        port.collapse_traffic_lights(pd.read_csv(export_dir / "_annotations.csv")), export_dir)
    tr, te = port.split_dataframe(df, n_splits=3, seed=seed)
    assert not (set(tr["filename"]) & set(te["filename"]))
    assert len(tr) + len(te) == len(df)
    rtr, rte = ref.split_dataframe(df, n_splits=3, seed=seed)
    pd.testing.assert_frame_equal(tr, rtr)
    pd.testing.assert_frame_equal(te, rte)


def test_full_preprocess_equals_the_jax_package(export_dir, tmp_path_factory):
    train_dir, test_dir = port.preprocess(export_dir, tmp_path_factory.mktemp("clean"))
    rtrain, rtest = ref.preprocess(export_dir, tmp_path_factory.mktemp("clean_ref"))
    tr = pd.read_csv(train_dir / "train_annotate.csv")
    te = pd.read_csv(test_dir / "test_annotate.csv")
    assert not tr["class"].str.startswith("trafficLight-").any()
    pd.testing.assert_frame_equal(tr, pd.read_csv(rtrain / "train_annotate.csv"))
    pd.testing.assert_frame_equal(te, pd.read_csv(rtest / "test_annotate.csv"))
    for d, rd in ((train_dir, rtrain), (test_dir, rtest)):
        names = sorted(p.name for p in d.glob("*.jpg"))
        assert names and names == sorted(p.name for p in rd.glob("*.jpg"))
        assert (d / names[0]).read_bytes() == (export_dir / names[0]).read_bytes()


def test_command_prints_both_lines(export_dir, tmp_path_factory, capsys):
    out = tmp_path_factory.mktemp("cli")
    port.main([str(export_dir), str(out), "--seed", "724"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("train: ") and lines[0].endswith(str(out / "train"))
    assert lines[1].startswith("test:  ") and lines[1].endswith(str(out / "test"))
