"""Distributed trace context for the serving plane (a copy of
shifu_tpu/obs/tracing.py).

One request = one trace.  A compact trace id is minted at ingress (or
accepted from the client's wire frame) and carried through every hop: the
wire protocol's version-2 frames (runtime/serve_wire.py), then the
daemon's lifecycle stage chain (runtime/serve.py), whose sampled
`request_trace` events carry the id and the attempt as `trace_id` and
`hop`.

The context is tiny and flat: 16 hex chars of id, an attempt ordinal and
a sampled bit, 20 bytes on the wire.  A member force-samples any request
that arrives with `sampled=True`, so a trace's hops never go dark.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

# trace extension block of a version-2 wire frame (serve_wire.py): the
# fixed header is unchanged; ver=2 means these 20 bytes sit between the
# header and the payload.  trace_id as raw ascii-hex (16 bytes), attempt
# u8, sampled u8, reserved u16 for a future flags word.
WIRE_EXT = struct.Struct("<16sBBH")
WIRE_EXT_BYTES = WIRE_EXT.size

_ID_LEN = 16  # hex chars (64 bits of id space)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's trace identity as it crosses a hop boundary."""

    trace_id: str        # 16 lowercase hex chars
    attempt: int = 0     # hop ordinal at the router (0 primary, 1 hedge)
    sampled: bool = True  # journal this trace's spans?

    def pack(self) -> bytes:
        """The 20-byte wire extension of a version-2 frame."""
        return WIRE_EXT.pack(self.trace_id.encode("ascii"),
                             min(max(self.attempt, 0), 255),
                             1 if self.sampled else 0, 0)


def mint() -> TraceContext:
    """A fresh sampled trace context (router-ingress minting)."""
    return TraceContext(trace_id=os.urandom(8).hex())


def unpack(raw: bytes) -> Optional[TraceContext]:
    """Wire extension bytes -> TraceContext; a malformed block is None
    (the request still serves — tracing is telemetry, never a gate)."""
    if len(raw) != WIRE_EXT_BYTES:
        return None
    try:
        tid, attempt, sampled, _reserved = WIRE_EXT.unpack(raw)
        trace_id = tid.decode("ascii")
    except (struct.error, UnicodeDecodeError):
        return None
    if len(trace_id) != _ID_LEN or not all(
            c in "0123456789abcdef" for c in trace_id):
        return None
    return TraceContext(trace_id=trace_id, attempt=int(attempt),
                        sampled=bool(sampled))
