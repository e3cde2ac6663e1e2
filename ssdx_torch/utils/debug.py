"""Numerical-debugging switches, the port's counterpart of ``ssdx/utils/debug.py``.

The JAX package traps NaNs inside jitted code with ``jax_debug_nans``; the
PyTorch analogs are autograd's anomaly detection (a backward that produces
NaN raises, with the forward's traceback) plus a finite check of the loss in
the train step (``ssdx_torch/train/step.py`` reads :func:`nan_checks_enabled`).
``enable_x64`` makes float64 the default dtype for numerical cross-checks.
"""
from __future__ import annotations

import math

import torch

__all__ = ["enable_nan_checks", "disable_nan_checks", "nan_checks_enabled",
           "check_finite_loss", "enable_x64"]

_nan_checks = False


def enable_nan_checks() -> None:
    """Raise on a NaN produced in a backward pass and on a train-step loss
    that is not finite.  Both cost time: anomaly mode records tracebacks, and
    the loss check waits for the device every step."""
    global _nan_checks
    _nan_checks = True
    torch.autograd.set_detect_anomaly(True)


def disable_nan_checks() -> None:
    global _nan_checks
    _nan_checks = False
    torch.autograd.set_detect_anomaly(False)


def nan_checks_enabled() -> bool:
    return _nan_checks


def check_finite_loss(loss, step: int) -> None:
    """Raise ``FloatingPointError`` unless ``loss`` is finite."""
    value = float(loss)
    if not math.isfinite(value):
        raise FloatingPointError(f"loss is {value} at step {step}")


def enable_x64(on: bool = True) -> None:
    """Double precision by default, for numerical cross-checks (not for
    training)."""
    torch.set_default_dtype(torch.float64 if on else torch.float32)
