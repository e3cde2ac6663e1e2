"""The H100 SXM's dense peaks and the roofline bound the port's kernels are
held to.

The peaks are NVIDIA's data sheet figures at the 700 W limit; a card set
below that limit reaches less.  Each caller counts its own kernel's
operations and bytes and asks :func:`bound_ms` for the least time.
"""
from __future__ import annotations

__all__ = ["PEAK_BF16", "PEAK_INT8", "PEAK_F32", "PEAK_BYTES", "bound_ms"]

PEAK_BF16 = 989e12   # FLOP/s, bf16 tensor cores
PEAK_INT8 = 1979e12  # OP/s, int8 tensor cores
PEAK_F32 = 67e12     # FLOP/s, float32 on the CUDA cores
PEAK_BYTES = 3.35e12  # B/s, HBM3


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """``max(ops / peak, nbytes / PEAK_BYTES)`` in ms, and the term that
    binds: "operations" or "bytes"."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"
