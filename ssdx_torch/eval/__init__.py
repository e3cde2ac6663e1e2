"""Evaluation: mAP@0.5 (``ssdx_torch.eval.map``) and the test-set command
(``ssdx_torch.eval.run``)."""
