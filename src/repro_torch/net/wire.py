"""Wire format: KV records packed into MTU-sized aggregation packets
(DESIGN.md §7; paper §4.1 Table 1 aggregation packets, Eq. 1/2 framing).

THE single source of byte-size constants.  ``PAIR_BYTES`` used to live as a
literal in ``examples/wordcount_switchagg.py`` and the 58 B Ethernet-domain
header / 2 B per-pair metadata as literals in ``core/reduction_model.py``;
every byte model now imports them from here so the analytic layer, the
packet simulator, and the examples cannot drift apart.

This module is pure Python/numpy (no jax) so ``core.reduction_model`` —
itself jax-free by design — can depend on it at import time.

A packet is an aggregation header riding the usual Ethernet/IP/UDP stack
(Eq. 2's 58 B ``H``) plus up to ``RECORDS_PER_PACKET`` variable-length
pairs.  The aggregation header carries what the switch needs to combine
exactly once: job id (which tree), tree level, per-flow PSN (the
transport's dedupe key), record count, and an end-of-task flag that
triggers the downstream flush.  Under failure recovery (DESIGN.md §12)
the header also carries the job's ``epoch`` — the restart incarnation
number — so a receiver can tell a retransmission of the same
incarnation (duplicate, discard) from a replay after a restart (new
incarnation, accept from PSN 0).  The epoch rides in header bits the
12 B aggregation header already reserves (flags/PSN space), so the
byte-model constants below are unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# --- pair encoding (paper §2.1 / Eq. 1) ------------------------------------

KEY_BYTES = 4  # our keys are int32 word ids; real keys are 16-64 B strings
VALUE_BYTES = 4
PAIR_META_BYTES = 2  # SwitchAgg variable-length encoding: per-pair length tag
#: Average on-wire bytes of one variable-length (key, value) pair including
#: its metadata (paper workloads: 16-64 B keys).  The repo-wide byte unit.
PAIR_BYTES = 24

# --- packet framing (Eq. 2 domain) ------------------------------------------

ETH_HEADER_BYTES = 58  # Eq. (2)'s H: Ethernet + IP + UDP headers
#: job_id(2) + flow_id(2) + level(1) + psn(4) + n_records(2) + flags(1)
AGG_HEADER_BYTES = 12
HEADER_BYTES = ETH_HEADER_BYTES + AGG_HEADER_BYTES
MTU_BYTES = 1500
MAX_PAYLOAD_BYTES = MTU_BYTES - HEADER_BYTES
#: Records one MTU-sized aggregation packet carries.
RECORDS_PER_PACKET = MAX_PAYLOAD_BYTES // PAIR_BYTES


@dataclasses.dataclass(frozen=True)
class PacketHeader:
    """The aggregation header (paper Table 1 "aggregation packet")."""

    job_id: int
    flow_id: int  # sender edge within the job's tree (transport flow key)
    level: int  # tree level of the RECEIVING node; mappers send level 0
    psn: int  # per-flow packet sequence number (go-back-N / dedupe key)
    n_records: int
    eot: bool = False  # end-of-task: sender has no more records
    epoch: int = 0  # restart incarnation (DESIGN.md §12); 0 = never restarted


@dataclasses.dataclass(frozen=True)
class Packet:
    """One framed packet: header + a slice of the KV record stream.

    ``values`` may carry trailing lane dims (an op's carried representation,
    e.g. ``mean``'s (sum, count)); the byte model always charges the average
    ``PAIR_BYTES`` per record — lanes are a semantic, not a wire, detail.
    """

    header: PacketHeader
    keys: np.ndarray  # [n_records] int32
    values: np.ndarray  # [n_records] or [n_records, lanes]

    @property
    def payload_bytes(self) -> int:
        return self.header.n_records * PAIR_BYTES

    @property
    def wire_bytes(self) -> int:
        return HEADER_BYTES + self.payload_bytes


def pack_records(
    keys,
    values,
    *,
    job_id: int = 0,
    flow_id: int = 0,
    level: int = 0,
    start_psn: int = 0,
    records_per_packet: int = RECORDS_PER_PACKET,
    eot: bool = False,
    epoch: int = 0,
) -> list[Packet]:
    """Split a record stream into MTU-framed packets, PSNs consecutive from
    ``start_psn``.  With ``eot`` the last packet carries the end-of-task
    flag; an empty stream with ``eot`` still emits one empty EoT packet (the
    flush trigger must cross the wire)."""
    if records_per_packet < 1:
        raise ValueError("records_per_packet must be >= 1")
    keys = np.asarray(keys)
    values = np.asarray(values)
    if keys.shape[0] != values.shape[0]:
        raise ValueError("keys/values leading dims differ")
    n = keys.shape[0]
    packets: list[Packet] = []
    n_packets = max(1, math.ceil(n / records_per_packet)) if (n or eot) else 0
    for i in range(n_packets):
        lo, hi = i * records_per_packet, min(n, (i + 1) * records_per_packet)
        packets.append(Packet(
            header=PacketHeader(
                job_id=job_id, flow_id=flow_id, level=level,
                psn=start_psn + i, n_records=hi - lo,
                eot=eot and i == n_packets - 1, epoch=epoch),
            keys=keys[lo:hi], values=values[lo:hi]))
    return packets


def stream_wire_bytes(n_records: int,
                      records_per_packet: int = RECORDS_PER_PACKET) -> int:
    """Total on-wire bytes of a record stream: payload plus one header per
    packet — Eq. (2) with ceil framing (the paper floors because it counts
    only *full* extra packets; a framed stream pays for its tail too)."""
    if n_records <= 0:
        return 0
    n_packets = math.ceil(n_records / records_per_packet)
    return n_records * PAIR_BYTES + n_packets * HEADER_BYTES
