"""Roofline analysis of the port on the H100 (port of `repro.roofline`):
`analysis` (the op-level write-once cost of a call, `count_cost`, and the
three-term `roofline_terms` over a `Hardware` record), `kernels` (each
kernel's cost from its shapes, and `bound_ms`), `kv_bytes` (bytes per
decode step and token) and `report` (the roofline table of dry-run
artifacts)."""
from repro_torch.roofline.analysis import (H100, CostTotals, Hardware,
                                           count_cost, roofline_terms)
from repro_torch.roofline.kernels import KernelCost, bound_ms

__all__ = ["CostTotals", "H100", "Hardware", "KernelCost", "bound_ms",
           "count_cost", "roofline_terms"]
