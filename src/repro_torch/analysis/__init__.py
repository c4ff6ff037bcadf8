"""Contract checking for the port (port of `repro.analysis`): the
collective census of a call, declarative contracts, signature budgets on
entry points and the repo-specific lint, gated by `analysis.cli`."""
from repro_torch.analysis.census import COLLECTIVES, Census, collective_census

__all__ = ["COLLECTIVES", "Census", "collective_census"]
