"""Snow DATA frame size (copied from ``repro.core.messages.Data``).

Only the byte accounting is needed by the closed-form sweep: a 58-byte
header plus the payload, so a 64-byte payload gives the paper's
122-byte Snow RMR (244 for the Coloring double tree)."""
from __future__ import annotations

from dataclasses import dataclass

from .ids import ENDPOINT_BYTES, MSG_ID_BYTES

DEFAULT_PAYLOAD = 64
_TYPE_BYTES = 2          # message type + flags


@dataclass(frozen=True)
class Data:
    """Broadcast DATA frame: id + region boundaries + payload."""

    payload: int = DEFAULT_PAYLOAD

    @property
    def size(self) -> int:
        # msg id 16, two 18 B region boundaries, type/flags 2, tree 2,
        # length 2 = 58 B header
        return MSG_ID_BYTES + 2 * ENDPOINT_BYTES + 3 * _TYPE_BYTES \
            + self.payload
