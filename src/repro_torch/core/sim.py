"""Link latency parameters (copied from ``repro.core.sim.LatencyModel``).

The event loop is not ported: the closed-form sweep only needs the
lognormal parameters of the intra-datacenter one-way latency."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LatencyModel:
    """Lognormal, sub-millisecond one-way latency."""

    median_s: float = 0.0004
    sigma: float = 0.35
