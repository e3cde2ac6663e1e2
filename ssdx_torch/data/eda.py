"""Dataset statistics CLI.

The port's own copy of ``ssdx/data/eda.py``.  Reports per-class box counts,
the objects-per-image distribution and box area-fraction statistics (the
tiny median motivates the IoU crop of the augmentation) and, with
``--measure-augment``, measures the area fractions again after the training
augmentation of ``ssdx_torch/data/augment.py``, which quantifies the crop's
zoom-in effect.  The augmentation runs on the GPU unless ``--cpu`` is given.

Usage: ``python -m ssdx_torch.data.eda DATA_DIR [--measure-augment] [--cpu]``
"""
from __future__ import annotations

import argparse

import numpy as np

from .dataset import DetectionDataset

__all__ = ["dataset_stats", "augmented_area_stats", "main"]


def dataset_stats(ds: DetectionDataset) -> dict:
    """Class histogram, objects/image distribution, raw box area fractions."""
    class_counts = {c: 0 for c in ds.classes}
    objs_per_image = []
    area_fracs = []
    for i in range(len(ds)):
        boxes, labels = ds.annotations(i)
        objs_per_image.append(len(labels))
        for lb in labels:
            class_counts[ds.idx_to_class[int(lb)]] += 1
        if len(boxes):
            # avoid decoding images: canvas size comes from the CSV columns
            rows = ds._by_file.get(ds.paths[i].stem + ".jpg")
            w = float(rows["width"].iloc[0]) if rows is not None and "width" in rows else 512.0
            h = float(rows["height"].iloc[0]) if rows is not None and "height" in rows else 512.0
            a = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
                boxes[:, 3] - boxes[:, 1], 0, None
            )
            area_fracs.extend((a / (w * h)).tolist())
    objs = np.asarray(objs_per_image)
    areas = np.asarray(area_fracs) if area_fracs else np.zeros(0)
    return {
        "n_images": len(ds),
        "n_boxes": int(objs.sum()),
        "class_counts": class_counts,
        "objects_per_image": {
            "mean": float(objs.mean()) if len(objs) else 0.0,
            "median": float(np.median(objs)) if len(objs) else 0.0,
            "max": int(objs.max()) if len(objs) else 0,
            "empty_images": int((objs == 0).sum()),
        },
        "area_frac": {
            "median": float(np.median(areas)) if len(areas) else 0.0,
            "mean": float(areas.mean()) if len(areas) else 0.0,
            "p90": float(np.percentile(areas, 90)) if len(areas) else 0.0,
        },
    }


def augmented_area_stats(
    ds: DetectionDataset, n_batches: int = 8, batch_size: int = 16, seed: int = 724, device=None
) -> dict:
    """Box area fractions after the training augmentation pipeline, which
    quantifies the IoU crop's zoom-in effect.  ``device=None`` is the GPU."""
    from .pipeline import DetectionLoader

    loader = DetectionLoader(
        ds, batch_size, train=True, num_workers=4, seed=seed, prefetch=False, device=device
    )
    fracs = []
    for i, item in enumerate(loader):
        if i >= n_batches:
            break
        b = item.batch.gt_boxes.cpu().numpy()
        v = item.batch.gt_valid.cpu().numpy()
        a = np.clip(b[..., 2] - b[..., 0], 0, None) * np.clip(
            b[..., 3] - b[..., 1], 0, None
        )
        fracs.extend(a[v].tolist())
    arr = np.asarray(fracs) if fracs else np.zeros(0)
    return {
        "n_boxes_sampled": len(arr),
        "median": float(np.median(arr)) if len(arr) else 0.0,
        "mean": float(arr.mean()) if len(arr) else 0.0,
        "p90": float(np.percentile(arr, 90)) if len(arr) else 0.0,
    }


def main(argv=None) -> None:
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data_dir")
    ap.add_argument("--measure-augment", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="augment on the CPU, not the GPU")
    args = ap.parse_args(argv)
    ds = DetectionDataset(args.data_dir)
    out = dataset_stats(ds)
    if args.measure_augment:
        out["augmented_area_frac"] = augmented_area_stats(
            ds, device="cpu" if args.cpu else None)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
