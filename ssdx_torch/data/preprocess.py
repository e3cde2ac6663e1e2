"""Raw-dataset preprocessing CLI: Kaggle Udacity export -> clean train/test
directories.

The port's own copy of ``ssdx/data/preprocess.py`` (pandas and numpy on the
host, no device work):

  1. read ``_annotations.csv`` from the export directory;
  2. collapse the six ``trafficLight-*`` subclasses to ``trafficLight``;
  3. diff the image listing against the CSV filenames; images with no
     annotations become ``class='empty'`` rows with width=height=512;
  4. StratifiedGroupKFold(n_splits=3, shuffle, seed=724), stratified by
     class, grouped by filename, first fold (needs scikit-learn, imported
     where it is used);
  5. write ``train_annotate.csv`` / ``test_annotate.csv`` and copy images
     into ``train/`` / ``test/``.

Usage: ``python -m ssdx_torch.data.preprocess EXPORT_DIR OUT_DIR [--seed 724]``
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import pandas as pd

__all__ = ["collapse_traffic_lights", "add_empty_rows", "split_dataframe", "preprocess"]


def collapse_traffic_lights(df: pd.DataFrame) -> pd.DataFrame:
    """Map every class starting with 'trafficLight' to plain 'trafficLight'."""
    df = df.copy()
    mask = df["class"].astype(str).str.startswith("trafficLight")
    df.loc[mask, "class"] = "trafficLight"
    return df


def add_empty_rows(df: pd.DataFrame, export_dir: Path, size: int = 512) -> pd.DataFrame:
    """Append 'empty' rows for images present on disk but absent from the CSV."""
    on_disk = {p.name for p in export_dir.glob("*.jpg")}
    annotated = set(df["filename"].unique())
    empties = sorted(on_disk - annotated)
    if not empties:
        return df
    rows = pd.DataFrame(
        {
            "filename": empties,
            "width": size,
            "height": size,
            "class": "empty",
            "xmin": 0,
            "ymin": 0,
            "xmax": 0,
            "ymax": 0,
        }
    )
    return pd.concat([df, rows], ignore_index=True)


def split_dataframe(
    df: pd.DataFrame, n_splits: int = 3, seed: int = 724
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """First StratifiedGroupKFold fold; asserts zero group leakage."""
    from sklearn.model_selection import StratifiedGroupKFold

    groups = df["filename"]
    sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    tr_idx, te_idx = next(sgkf.split(df.drop(columns=["class"]), df["class"], groups))
    train_df = df.iloc[tr_idx].reset_index(drop=True)
    test_df = df.iloc[te_idx].reset_index(drop=True)
    assert not (set(train_df["filename"]) & set(test_df["filename"]))
    return train_df, test_df


def preprocess(
    export_dir: str | Path,
    out_dir: str | Path,
    n_splits: int = 3,
    seed: int = 724,
    annotations_name: str = "_annotations.csv",
) -> tuple[Path, Path]:
    """Run the full pipeline; returns (train_dir, test_dir)."""
    export_dir = Path(export_dir)
    out_dir = Path(out_dir)
    df = pd.read_csv(export_dir / annotations_name)
    df = collapse_traffic_lights(df)
    df = add_empty_rows(df, export_dir)
    train_df, test_df = split_dataframe(df, n_splits=n_splits, seed=seed)

    train_dir = out_dir / "train"
    test_dir = out_dir / "test"
    for sub_dir, sub_df, csv_name in (
        (train_dir, train_df, "train_annotate.csv"),
        (test_dir, test_df, "test_annotate.csv"),
    ):
        sub_dir.mkdir(parents=True, exist_ok=True)
        sub_df.to_csv(sub_dir / csv_name, index=False)
        for name in sub_df["filename"].unique():
            src = export_dir / name
            if src.exists():
                shutil.copy2(src, sub_dir / name)
    return train_dir, test_dir


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("export_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--n-splits", type=int, default=3)
    ap.add_argument("--seed", type=int, default=724)
    ap.add_argument("--annotations-name", default="_annotations.csv")
    args = ap.parse_args(argv)
    train_dir, test_dir = preprocess(
        args.export_dir,
        args.out_dir,
        n_splits=args.n_splits,
        seed=args.seed,
        annotations_name=args.annotations_name,
    )
    tr = pd.read_csv(train_dir / "train_annotate.csv")
    te = pd.read_csv(test_dir / "test_annotate.csv")
    print(f"train: {tr['filename'].nunique()} images / {len(tr)} rows -> {train_dir}")
    print(f"test:  {te['filename'].nunique()} images / {len(te)} rows -> {test_dir}")


if __name__ == "__main__":
    main()
