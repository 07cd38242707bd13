"""Wire sizes used for RMR accounting (copied from ``repro.core.ids``):
18 bytes per endpoint (IPv6 + 2-byte port), 16-byte message ids."""
from __future__ import annotations

NodeId = int

ENDPOINT_BYTES = 18
MSG_ID_BYTES = 16
