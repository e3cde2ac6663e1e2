"""The input pipeline: dataset, split, synthetic scenes, loader and on-device augmentation."""
