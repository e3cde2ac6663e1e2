"""Evaluation: mAP@0.5 (``ssdx_torch.eval.map``)."""
