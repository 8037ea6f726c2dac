"""Per-link bandwidth / latency / FIFO-queue model (DESIGN.md §7).

One :class:`Link` is a point-to-point edge of the aggregation tree (mapper
-> level-0 switch, switch -> parent switch, root -> reducer).  It is a
serialization resource: a packet occupies the link for ``bytes / rate``
seconds, FIFO, plus a fixed propagation delay — the classic
store-and-forward pipe the drain-time scoring in ``core.planner`` models
as ``bytes / (gbps * 1e9)``.

``gbps`` follows the repo-wide planner convention (``JobScheduler._drain_s``,
``core.tree.ICI_GBPS``): units of 1e9 **bytes**/s, so 1.25 ≈ a 10 GbE link.

Links accumulate telemetry (wire bytes, payload bytes, serialization
occupancy, queueing delay) that ``net.sim`` aggregates per tree level —
the measured counterpart of the planner's modeled level bytes, and the
input to its drain-time calibration.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable


@dataclasses.dataclass
class Link:
    """A FIFO serialization pipe with accounting."""

    name: str
    axis: str  # tree level / topology axis this link belongs to
    gbps: float  # 1e9 bytes per second (planner convention)
    propagation_s: float = 1e-6
    # -- state + telemetry ---------------------------------------------------
    busy_until: float = 0.0
    bytes_sent: int = 0
    payload_bytes: int = 0
    packets_sent: int = 0
    busy_s: float = 0.0
    queue_delay_s: float = 0.0

    def __post_init__(self):
        if self.gbps <= 0:
            raise ValueError(f"link {self.name}: gbps must be positive")

    def serialize_s(self, n_bytes: int) -> float:
        return n_bytes / (self.gbps * 1e9)

    def transmit(self, t_ready: float, n_bytes: int,
                 payload_bytes: int = 0) -> tuple[float, float]:
        """Serialize one packet; returns (t_departed, t_arrived).

        ``t_ready`` is when the sender has the packet; the link starts when
        both the packet and the pipe are ready (FIFO queueing), occupies the
        pipe for the serialization time, and the far end sees the packet one
        propagation delay after the last byte left.
        """
        start = max(t_ready, self.busy_until)
        self.queue_delay_s += start - t_ready
        ser = self.serialize_s(n_bytes)
        self.busy_until = start + ser
        self.busy_s += ser
        self.bytes_sent += n_bytes
        self.payload_bytes += payload_bytes
        self.packets_sent += 1
        return self.busy_until, self.busy_until + self.propagation_s


def from_budget(budget, *, name: str | None = None,
                propagation_s: float = 1e-6) -> Link:
    """Build a Link from a ``planner.LinkBudget``-shaped object (duck-typed
    on ``axis``/``gbps`` so this module never imports the planner)."""
    return Link(name=name or budget.axis, axis=budget.axis,
                gbps=budget.gbps, propagation_s=propagation_s)


def stats_by_axis(links: Iterable[Link]) -> dict[str, dict]:
    """Aggregate per-link telemetry into per-axis (tree level) totals.

    ``drain_s`` is the busiest single link's serialization occupancy — the
    measured counterpart of the planner's modeled ``load / rate`` drain.
    """
    out: dict[str, dict] = defaultdict(lambda: {
        "links": 0, "bytes": 0, "payload_bytes": 0, "packets": 0,
        "busy_s": 0.0, "drain_s": 0.0, "queue_delay_s": 0.0,
    })
    for l in links:
        s = out[l.axis]
        s["links"] += 1
        s["bytes"] += l.bytes_sent
        s["payload_bytes"] += l.payload_bytes
        s["packets"] += l.packets_sent
        s["busy_s"] += l.busy_s
        s["drain_s"] = max(s["drain_s"], l.busy_s)
        s["queue_delay_s"] += l.queue_delay_s
    return dict(out)
