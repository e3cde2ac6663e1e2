"""CSV + JPEG detection dataset (host side).

Same data contract as the reference's ``ImageClass`` /
``get_file_path_plus_dataframe`` (CarImageClass.py:17-399): a target directory
holding ``*.jpg`` images and exactly one annotation ``*.csv`` with columns
``filename, class, xmin, ymin, xmax, ymax`` (warn if several CSVs,
CarImageClass.py:378-380).  Classes are the sorted unique CSV classes minus
``'empty'`` (:43-47); ``class_to_idx`` is alphabetical and 0-based; rows are
grouped by filename; images without (valid) rows are background images with
zero boxes (:90-97).  Sub-sampling via ``file_pct`` + ``rand_seed=724`` or an
explicit ``file_list`` (:365-391) is preserved.

``__getitem__`` returns a numpy HWC uint8 image and plain numpy boxes and
labels; decode is cv2 (libjpeg-turbo under the hood).  Augmentation runs
batched on the device (``ssdx_torch/data/augment.py``), so no per-sample
transform is needed, though a host-side ``transform(img, target)`` hook is
still honored.

The port's own copy of ``ssdx/data/dataset.py`` (host-side numpy, pandas and
cv2), less ``show_with_box``: the port's ``viz`` module has no ground-truth
plot yet.
"""
from __future__ import annotations

import pathlib
import warnings
from typing import Callable

import numpy as np
import pandas as pd

__all__ = ["DetectionDataset", "scan_directory"]

SEED = 724  # the reference's global seed (CarImageClass.py:35 etc.)


def scan_directory(
    targ_dir: str | pathlib.Path,
    rand_seed: int | None = SEED,
    file_list: list | None = None,
    file_pct: float = 1.0,
) -> tuple[list[pathlib.Path], pd.DataFrame]:
    """Paths + annotation dataframe (reference get_file_path_plus_dataframe,
    CarImageClass.py:346-399)."""
    targ_dir = pathlib.Path(targ_dir)
    if file_list is None:
        all_paths = sorted(targ_dir.glob("*.jpg"))
    else:
        all_paths = [targ_dir / n for n in file_list]
        file_pct = 1.0

    if not (0.0 <= file_pct <= 1.0):
        raise TypeError("file_pct must be between 0 and 1.")

    csvs = sorted(targ_dir.glob("*.csv"))
    if len(csvs) > 1:
        warnings.warn(
            f"There are multiple .csv files in {targ_dir}; bounding-box/label "
            "errors likely."
        )
    if not csvs:
        raise FileNotFoundError(f"no annotation .csv found in {targ_dir}")
    df = pd.read_csv(csvs[0])

    if file_pct != 1.0:
        rng = np.random.default_rng(rand_seed)
        n = int(np.floor(len(all_paths) * file_pct))
        paths = list(rng.choice(np.asarray(all_paths, dtype=object), size=n, replace=False))
        names = {p.stem + ".jpg" for p in paths}
        df = df[df["filename"].isin(names)]
    else:
        paths = all_paths
        if file_list is not None:
            df = df[df["filename"].isin(set(file_list))]

    return paths, df


class DetectionDataset:
    """Map-style dataset: index -> (image uint8 HWC, target dict).

    target = {"boxes": float32 [n,4] xyxy abs pixels, "labels": int64 [n],
    "image_id": int64 [1], optional "areas": float32 [n]} — the reference's
    __getitem__ contract (CarImageClass.py:68-135).
    """

    def __init__(
        self,
        targ_dir: str | pathlib.Path,
        file_list: list | None = None,
        transform: Callable | None = None,
        file_pct: float = 1.0,
        rand_seed: int | None = SEED,
        include_area: bool = False,
    ):
        self.directory = pathlib.Path(targ_dir)
        self.transform = transform
        self.paths, self.annotate_df = scan_directory(
            targ_dir, rand_seed=rand_seed, file_list=file_list, file_pct=file_pct
        )
        classes = sorted(set(self.annotate_df["class"].unique()) - {"empty"})
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.idx_to_class = {i: c for c, i in self.class_to_idx.items()}
        self.include_area = include_area

        mapped = self.annotate_df.copy()
        mapped["class"] = mapped["class"].map(self.class_to_idx)
        self._by_file = {
            fname: g.reset_index(drop=True) for fname, g in mapped.groupby("filename")
        }

    def __len__(self) -> int:
        return len(self.paths)

    def load_image(self, index: int) -> np.ndarray:
        """Decode one JPEG to RGB uint8 HWC via cv2 (libjpeg-turbo)."""
        import cv2

        img = cv2.imread(str(self.paths[index]), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to decode {self.paths[index]}")
        return img[:, :, ::-1]  # BGR -> RGB

    def annotations(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """(boxes xyxy float32 [n,4], labels int64 [n]) for one image;
        background images return empty arrays."""
        name = self.paths[index].stem + ".jpg"
        rows = self._by_file.get(name)
        if rows is None or rows["class"].notna().sum() == 0:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        rows = rows[rows["class"].notna()]
        boxes = rows[["xmin", "ymin", "xmax", "ymax"]].to_numpy(np.float32)
        labels = rows["class"].to_numpy(np.int64)
        return boxes, labels

    def max_boxes_per_image(self) -> int:
        """Largest number of (valid) GT boxes on any image in this dataset —
        used to auto-size fixed-shape GT padding so no ground truth is ever
        silently truncated (the reference's ragged targets lose nothing,
        CarImageClass.py:99-120)."""
        names = {p.stem + ".jpg" for p in self.paths}
        best = 0
        for fname, rows in self._by_file.items():
            if fname in names:
                best = max(best, int(rows["class"].notna().sum()))
        return best

    def native_size(self) -> tuple[int, int] | None:
        """(h, w) if the dataset's images share one native resolution, else
        None.  Prefers the annotation CSV's width/height columns (the
        preprocess pipeline writes them, C25); falls back to decoding a
        small sample of images.  Used by the loader to pick a source size
        that makes eval preprocessing a SINGLE antialiased resample from
        native resolution (the reference resizes once,
        SSD_from_scratch.py:554-560)."""
        df = self.annotate_df
        if {"width", "height"}.issubset(df.columns) and len(df):
            ws, hs = df["width"].unique(), df["height"].unique()
            if len(ws) == 1 and len(hs) == 1:
                return int(hs[0]), int(ws[0])
            return None
        sizes = {self.load_image(i).shape[:2] for i in range(min(len(self), 8))}
        return sizes.pop() if len(sizes) == 1 else None

    def __getitem__(self, index: int):
        img = self.load_image(index)
        h, w = img.shape[:2]
        boxes, labels = self.annotations(index)
        target = {
            "image_id": np.asarray([index], np.int64),
            "labels": labels,
            "boxes": boxes,
            "canvas_size": (h, w),
        }
        if self.transform is not None:
            img, target = self.transform(img, target)
        if self.include_area:
            hh, ww = img.shape[:2]
            bw = np.clip(target["boxes"][:, 2] - target["boxes"][:, 0], 0, ww)
            bh = np.clip(target["boxes"][:, 3] - target["boxes"][:, 1], 0, hh)
            target["areas"] = (bw * bh).astype(np.float32)
        return img, target

    def show_with_box(self, index: int, **kwargs):
        """Plot one image with its GT boxes (and optional predictions) --
        the reference ImageClass.show_with_box (CarImageClass.py:142-337).
        Keyword args are forwarded to :func:`ssdx_torch.viz.show_with_box`."""
        from ..viz import show_with_box

        if index > len(self) or index < 0:
            raise ValueError(
                f"Index should be between 0 and {len(self)}, received {index}."
            )
        img, target = self[index]
        kwargs.setdefault("class_to_idx", self.class_to_idx)
        return show_with_box(img, target, **kwargs)
