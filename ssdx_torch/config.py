"""Dataclass configuration of the port.

The port's own copy of ``ssdx/config.py``: the same dataclasses with the
same defaults, every one the reference's training run (the best "no
zoom-out, bootstrap" recipe).  ``TrainConfig.fused_stem`` selects the
train-mode stem kernel (``ssdx_torch/ops/stem_train.py``): None = on for a
full-width model on a CUDA device, True/False = force.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["DataConfig", "TrainConfig", "EvalConfig", "Config"]


@dataclass(frozen=True)
class DataConfig:
    train_dir: str = "data/train"
    test_dir: str = "data/test"
    batch_size: int = 16  # notebook BATCH_SIZE
    num_workers: int = 8  # notebook NUM_WORKERS
    # None = auto: the dataset's uniform square native resolution (one
    # antialiased resample to 300; 512 happens to be Udacity native)
    source_size: int | None = None
    max_boxes: int | None = None  # None = auto-size from the dataset (no GT loss)
    val_fraction: float = 0.25  # notebook val split of train
    seed: int = 724
    bootstrap: bool = True  # best run uses bootstrap oversampling
    # Cache decoded (source-size) images in RAM across epochs — decode-bound
    # hosts only; costs source_size^2 * 3 bytes per training image.
    cache_images: bool = False
    zoom_out_prob: float = 0.0  # best run disables zoom-out
    min_area_frac: float = 0.02
    small_min_scale: float = 0.4
    large_min_scale: float = 0.7


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 150
    warmup_epochs: int = 5
    base_lr: float = 3e-3
    min_lr: float = 1e-6
    momentum: float = 0.9
    weight_decay: float = 5e-3  # the run used 0.005 (cell 2), not the fn default
    iou_thresh: float = 0.4  # matching threshold
    neg_pos_ratio: float = 3.0
    # "cosine" = per-step warmup-cosine (the reference's actual run,
    # sched_step_w_opt=True); "plateau" = per-epoch reduce-on-plateau on the
    # validation loss (the sched_step_w_opt=False intent, SSD_trainer.py:383)
    scheduler: str = "cosine"
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    early_stopping_rounds: int | None = None
    epoch_save_interval: int | None = None
    save_dir: str = "checkpoints"
    bfloat16: bool = True  # compute dtype of the activations
    # train-mode stem kernel (ssdx_torch/ops/stem_train.py): None = auto
    # (on for full-width runs on a CUDA device), True/False = force
    fused_stem: bool | None = None
    seed: int = 724
    # 1.0 = the reference SSD300; < 1 thins every channel count (fast
    # tests/experiments — see ssdx_torch.model.SSD300)
    width_mult: float = 1.0


@dataclass(frozen=True)
class EvalConfig:
    score_thresh: float = 0.2
    nms_thresh: float = 0.3
    max_per_img: int = 100


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    @classmethod
    def from_json(cls, path: str | Path) -> "Config":
        """Load a config with partial overrides from a JSON file of the shape
        {"data": {...}, "train": {...}, "eval": {...}}."""
        raw = json.loads(Path(path).read_text())
        return cls(
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            eval=EvalConfig(**raw.get("eval", {})),
        )

    def to_json(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))
