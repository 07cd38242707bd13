"""Edge-loss parameters (copied from ``repro.core.faults.LossModel``).

Only the fields the device loss planes read are kept; the host
splitmix64 draws and the repair model are not part of this port."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LossModel:
    """Per-link Bernoulli loss with timeout + geometric retransmit.

    ``rate`` — per-transmission loss probability; ``timeout_s`` — each
    failed attempt adds one timeout to the edge's latency;
    ``max_attempts`` — transmissions before the edge is dead."""

    rate: float = 0.0
    timeout_s: float = 0.25
    max_attempts: int = 4

    @property
    def active(self) -> bool:
        return self.rate > 0.0
