"""Calibration data errors (port of the part of `repro.data.synthetic` the
quantization pipeline uses)."""
from __future__ import annotations


class CalibrationDataError(ValueError):
    """A calibration batch failed up-front validation (empty, wrong
    rank/dtype, out-of-range ids) — raised with a clear message instead of
    a shape blowup deep inside the Gram accumulation."""
