"""Lossy transport: seeded loss injection + go-back-N retransmit
(DESIGN.md §7; P4COM-style end-host loss recovery).

The paper's switches aggregate — they consume records — so loss recovery
cannot be end-to-end: each tree edge runs its own reliable flow between
the sending end host (a mapper, or an upstream switch re-emitting its
eviction stream) and the receiving node.  The sender is go-back-N: it
streams a window of packets back-to-back; on a loss it times out and
rewinds to the lost PSN, resending everything from there.  The receiver
(``net.sim``'s switch ingest) delivers records to the cascade only for the
packet whose PSN it expects next — a gap (an earlier loss in flight) or a
duplicate (a retransmission of something already combined) is discarded
*before* touching the aggregation state, which is what makes every record
combine exactly once under any loss pattern (the transport property test).

Failure detection rides the same machinery (DESIGN.md §12): a
:class:`RetryPolicy` turns the constant RTO into capped exponential
backoff with a finite consecutive-timeout budget, after which the sender
raises :class:`PeerDeadError` — the timeout-driven "peer dead" verdict —
and an :class:`EdgeFault` injects time-based drops (a crashed receiving
switch, transient link-down windows).  Packets carry a restart epoch, and
the :class:`Receiver` dedupes across incarnations as well as PSNs.

Loss is a pure function of (seed, flow, psn, attempt): reproducible, and
independent retransmissions re-roll the dice.  :func:`loss_uniform` IS
that function — a vectorizable integer hash, not a stateful RNG — so the
per-packet node sender and the array-form vectorized sender (``net.vsim``)
consume identical draws by construction: one calls it with scalars, the
other with whole ``[links, window]`` batches, and the values cannot drift.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from . import links as links_lib
from . import wire

# splitmix64 finalizer constants (Steele et al.; the standard 64-bit mix)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 arrays (wrap-around arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def loss_uniform(seed, flow_id, psn, attempt):
    """THE seeded per-(flow, psn, attempt) loss draw, as a pure function.

    Returns uniforms in [0, 1) — scalar in, scalar out; array in
    (broadcasting), array out — computed by absorbing the four words into
    a splitmix64 sponge.  Both transport engines MUST draw through here:
    the go-back-N node sender calls it one packet at a time, the
    vectorized tier sender (``net.vsim``) calls it on whole
    ``[links, window]`` burst batches, and because it is the same pure
    function there is no seed-drift risk between them.
    """
    with np.errstate(over="ignore"):  # wrap-around is the hash
        h = _mix64(np.asarray(seed).astype(np.uint64) + _GOLDEN)
        for word in (flow_id, psn, attempt):
            h = _mix64(h + np.asarray(word).astype(np.uint64) + _GOLDEN)
    return h.astype(np.float64) * 2.0**-64


class LossModel:
    """Deterministic seeded packet-loss oracle.

    ``drop`` (scalar, the node sender's call) and ``drop_array`` (batched,
    the vectorized sender's call) evaluate the same :func:`loss_uniform`
    draw, so the two engines see identical loss patterns by construction.
    Subclasses overriding the pair (e.g. an explicit drop-mask model in
    the property tests) must keep them elementwise-consistent.
    """

    def __init__(self, rate: float = 0.0, seed: int = 0):
        if not 0.0 <= rate < 1.0:
            raise ValueError("loss rate must be in [0, 1)")
        self.rate = rate
        self.seed = seed

    def drop(self, flow_id: int, psn: int, attempt: int) -> bool:
        if self.rate <= 0.0:
            return False
        return bool(loss_uniform(self.seed, flow_id, psn, attempt)
                    < self.rate)

    def drop_array(self, flow_ids, psns, attempts) -> np.ndarray:
        """Batched ``drop``: bool array over broadcast (flow, psn, attempt)."""
        if self.rate <= 0.0:
            return np.zeros(np.broadcast(
                np.asarray(flow_ids), np.asarray(psns),
                np.asarray(attempts)).shape, bool)
        return loss_uniform(self.seed, flow_ids, psns, attempts) < self.rate


@dataclasses.dataclass
class FlowStats:
    """One flow's transport accounting."""

    packets_sent: int = 0  # transmissions, including retransmissions
    packets_dropped: int = 0
    retransmissions: int = 0
    timeouts: int = 0
    wire_bytes: int = 0


#: deliver(packet, t_arrive) — called for every packet that physically
#: arrives (i.e. was not dropped), including out-of-order ones the
#: receiver will discard on its PSN check.
DeliverFn = Callable[[wire.Packet, float], None]

MAX_ATTEMPTS = 10_000


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff policy of one go-back-N sender (DESIGN.md §12).

    The default reproduces the legacy sender bit-for-bit: constant RTO
    (``backoff=1.0`` — ``rto * 1.0**k == rto`` exactly in floats) and no
    retry budget (retry forever, up to the ``MAX_ATTEMPTS`` backstop).
    A failure-detection policy sets ``backoff > 1`` (each consecutive
    timeout without progress waits ``backoff``x longer, capped at
    ``max_timeout_s``) and a finite ``max_timeouts``: once that many
    consecutive timeouts pass without the window advancing, the sender
    declares the peer dead and raises :class:`PeerDeadError` — the
    timeout-driven crash verdict the fault plane turns into an epoch
    restart.
    """

    timeout_s: float | None = None  # base RTO; None = per-link conservative
    backoff: float = 1.0  # RTO multiplier per consecutive no-progress timeout
    max_timeout_s: float | None = None  # cap on the backed-off RTO
    max_timeouts: int | None = None  # consecutive-timeout budget; None = infinite

    def rto(self, base_rto: float, consecutive: int) -> float:
        """The RTO after ``consecutive`` prior no-progress timeouts."""
        v = base_rto * self.backoff ** consecutive
        if self.max_timeout_s is not None:
            v = min(v, self.max_timeout_s)
        return v


DEFAULT_RETRY = RetryPolicy()


class PeerDeadError(RuntimeError):
    """A sender exhausted its retry budget: the receiving node is declared
    dead.  ``t_s`` is the sender's clock at the verdict — the detection
    time the fault plane dates the epoch restart from."""

    def __init__(self, msg: str, *, t_s: float, flow_id: int, psn: int,
                 timeouts: int, stats: "FlowStats | None" = None):
        super().__init__(msg)
        self.t_s = t_s
        self.flow_id = flow_id
        self.psn = psn
        self.timeouts = timeouts
        self.stats = stats  # accounting up to the verdict (telemetry)


@dataclasses.dataclass(frozen=True)
class EdgeFault:
    """Time-based failure of one tree edge's receiving end (DESIGN.md §12).

    ``dead_from_s`` models a crashed receiving switch: every packet
    arriving at or after that instant is lost (nobody is listening).
    ``down_windows`` are transient link outages: arrivals inside any
    ``[t0, t1)`` window die on the wire.  Both compose with the random
    ``LossModel`` — a packet must survive the dice *and* the fault to be
    delivered.
    """

    dead_from_s: float | None = None
    down_windows: tuple[tuple[float, float], ...] = ()

    def lost(self, t_arrive: float) -> bool:
        if self.dead_from_s is not None and t_arrive >= self.dead_from_s:
            return True
        return any(t0 <= t_arrive < t1 for t0, t1 in self.down_windows)


def send_stream(
    packets: Sequence[tuple[float, wire.Packet]],
    link: links_lib.Link,
    loss: LossModel,
    *,
    flow_id: int,
    window: int = 16,
    timeout_s: float | None = None,
    deliver: DeliverFn,
    retry: RetryPolicy | None = None,
    fault: EdgeFault | None = None,
) -> tuple[float, FlowStats]:
    """Reliably deliver ``packets`` — a PSN-ordered list of
    ``(t_ready, Packet)`` — over one link with go-back-N.

    ``t_ready`` is when the sender *has* the packet (a switch cannot resend
    an eviction before producing it).  Returns (time the sender finished,
    i.e. the whole stream is known-delivered, stats).  Dropped packets still
    occupy the link — the wire carried them before they died.

    ``retry`` arms the backoff/verdict policy (default: legacy constant
    RTO, retry forever); ``fault`` injects time-based drops (dead peer,
    link-down windows).  Against a peer that is dead — or a window that
    outlives the retry budget — a finite ``retry.max_timeouts`` makes
    this raise :class:`PeerDeadError` instead of spinning to the
    ``MAX_ATTEMPTS`` backstop.
    """
    if retry is None:
        retry = DEFAULT_RETRY
    if timeout_s is None:
        timeout_s = retry.timeout_s
    if timeout_s is None:
        # conservative RTO: a full window's serialization plus one RTT
        timeout_s = 2.0 * (window * link.serialize_s(wire.MTU_BYTES)
                           + 2.0 * link.propagation_s)
    stats = FlowStats()
    attempts = [0] * len(packets)
    base = 0
    t = 0.0
    consecutive = 0  # timeouts since the window last advanced
    while base < len(packets):
        upto = min(base + window, len(packets))
        first_lost: int | None = None
        for psn in range(base, upto):
            t_ready, pkt = packets[psn]
            assert pkt.header.psn == psn, "packets must be PSN-ordered"
            attempts[psn] += 1
            if attempts[psn] > MAX_ATTEMPTS:
                raise RuntimeError(
                    f"flow {flow_id}: psn {psn} exceeded {MAX_ATTEMPTS} "
                    f"attempts (loss rate too close to 1?)")
            if attempts[psn] > 1:
                stats.retransmissions += 1
            # payload is credited once per PSN; retransmissions add wire
            # bytes only, so wire/payload drain calibration sees the loss
            depart, arrive = link.transmit(
                max(t, t_ready), pkt.wire_bytes,
                pkt.payload_bytes if attempts[psn] == 1 else 0)
            t = depart  # sender streams back-to-back
            stats.packets_sent += 1
            stats.wire_bytes += pkt.wire_bytes
            if (loss.drop(flow_id, psn, attempts[psn])
                    or (fault is not None and fault.lost(arrive))):
                stats.packets_dropped += 1
                if first_lost is None:
                    first_lost = psn
            else:
                deliver(pkt, arrive)
        if first_lost is None:
            base = upto
            consecutive = 0
        else:
            # sender discovers the loss one RTO after it stopped sending,
            # rewinds to the lost PSN (go-back-N), and resends from there
            stats.timeouts += 1
            if first_lost > base:
                consecutive = 0  # the window advanced: progress was made
            t += retry.rto(timeout_s, consecutive)
            consecutive += 1
            base = first_lost
            if (retry.max_timeouts is not None
                    and consecutive > retry.max_timeouts):
                raise PeerDeadError(
                    f"flow {flow_id}: psn {first_lost} undeliverable after "
                    f"{consecutive} consecutive timeouts — peer declared "
                    f"dead at t={t:.6f}s",
                    t_s=t, flow_id=flow_id, psn=first_lost,
                    timeouts=consecutive, stats=stats)
    return t, stats


class Receiver:
    """PSN-dedupe gate in front of an aggregation node.

    Tracks the next expected PSN per flow; :meth:`accept` returns True
    exactly once per (flow, psn) and only in order — the switch-side
    incomplete-aggregation handling: records of a lost packet re-enter the
    cascade via retransmission without ever double-combining.

    The gate also dedupes across restart *incarnations* (DESIGN.md §12):
    each packet carries its job epoch, and the receiver tracks the
    highest epoch it has seen.  A packet from an older epoch is an
    in-flight leftover of an aborted incarnation — discarded (counted in
    ``stale_epoch_discards``) before it can touch aggregation state.  A
    packet from a *newer* epoch announces a restart: the per-flow PSN map
    resets, so the children's epoch-tagged replays (which restart at
    PSN 0) are accepted rather than misread as duplicates of the dead
    incarnation's stream.  Within one epoch the behavior is exactly the
    pre-epoch gate.
    """

    def __init__(self):
        self.expected: dict[int, int] = {}
        self.epoch = 0
        self.gap_discards = 0
        self.duplicate_discards = 0
        self.stale_epoch_discards = 0

    def accept(self, header: wire.PacketHeader) -> bool:
        epoch = getattr(header, "epoch", 0)
        if epoch < self.epoch:
            self.stale_epoch_discards += 1
            return False
        if epoch > self.epoch:  # restart: new incarnation, PSNs reset
            self.epoch = epoch
            self.expected.clear()
        exp = self.expected.get(header.flow_id, 0)
        if header.psn == exp:
            self.expected[header.flow_id] = exp + 1
            return True
        if header.psn < exp:
            self.duplicate_discards += 1
        else:
            self.gap_discards += 1
        return False
