"""Vectorized tier engine of the packet simulator (DESIGN.md §10), ported
to torch (counterpart of ``repro/net/vsim.py``).

The node engine (``net.sim``) steps one ``dataplane.LevelState`` per
switch, packet by packet: on a card that is one FPE launch and one BPE
combine per packet per switch.  This module runs all of a tier's
per-packet table work at once: :func:`tier_ingest` steps every switch of
the tier through its accepted-packet sequence with ONE launch of the FPE
kernel over all the switch tables of the tier
(``kernels.kv_aggregate.fpe_scan_tables``), then one batched per-packet
BPE combine (``kvagg.sorted_combine_packets``).

Why one scan is enough: in exact-stream mode, stepping a switch packet by
packet with a resumed table equals one scan over the concatenation of its
packets, since a pair touches only its bucket's row and its own eviction
slot; the eviction slot of pair r of packet p is slot p * R + r of the
switch's stream, so the per-packet eviction streams fall out of the one
scan.  So the tier's tables, per-packet eviction streams and per-packet
combines are bit for bit the node engine's, as the differential tests
(``tests/test_torch_sim.py``) hold.

Host/device boundary, as in the JAX package: transport, link timing,
packetization and PSN acceptance stay on the host in numpy (the
``tier_start`` -> ``dispatch_tier_ingest`` -> ``tier_finish`` trio,
``run_tier_fast`` for one tier), at any loss rate; only the table work
goes to the device, and only what ``tier_finish`` reads comes back: the
tables, the per-packet counts, and the real output entries compacted on
the device.  ``dispatch_tier_ingest`` packs the kernel work of many
tiers (the concurrent jobs of a batched ``net.simulate``) sharing a
kernel-static signature into one ``tier_ingest`` call; the tables are
independent, so each job's slice is bit-identical to its solo run.

Shapes: ``S`` (switches) and ``P`` (packets) are the batch's own, with
no power-of-two padding (the JAX package pads to limit XLA retraces;
eager torch does not retrace).  A switch with fewer packets than ``P``
is padded with all-``EMPTY_KEY`` packets, which leave its table
untouched on both FPE paths.

Scope: a tier qualifies when it aggregates with ``capacity > 0``.
Capacity-0 (exact unbounded) and placement-disabled (forward-only)
levels keep their host paths.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import aggops, dataplane, kvagg
from repro_torch.kernels import kv_aggregate
from repro_torch.obs import trace as obs_trace
from . import links as links_lib
from . import transport, wire

_EMPTY = int(kvagg.EMPTY_KEY)


def supports(spec: dataplane.LevelSpec | None) -> bool:
    """True when a tier's per-packet FPE work can be batched on device.

    ``None`` (host-only baseline), disabled (forward-only relay), and
    capacity-0 (exact unbounded) levels do no per-packet FPE and keep
    the node engine's host paths.
    """
    return spec is not None and spec.enabled and spec.capacity > 0


def _fast_tier(keys, values, *, capacity: int, ways: int, op: str):
    """The ``exact_stream=False`` FPE of every switch, packet by packet:
    each packet's batched-block step (``kvagg._fpe_batched``) resumed from
    the table the previous one left, its ``[R + cap]`` eviction stream
    compacted to ``[R]`` (the real entries in order, a pure permutation:
    a packet of R records evicts at most R entries).  All-pad packets are
    skipped: they leave the table untouched."""
    s_n, p_n, r = keys.shape
    lane_shape = tuple(values.shape[3:])
    ways, n_buckets, cap = kvagg._fpe_geometry(capacity, ways)
    dev, vdt = keys.device, values.dtype
    tk = torch.full((s_n, cap), _EMPTY, dtype=torch.int32, device=dev)
    tv = torch.zeros((s_n, cap) + lane_shape, dtype=vdt, device=dev)
    ek = torch.full((s_n, p_n, r), _EMPTY, dtype=torch.int32, device=dev)
    ev = torch.zeros((s_n, p_n, r) + lane_shape, dtype=vdt, device=dev)
    ne = torch.zeros((s_n, p_n), dtype=torch.int32, device=dev)
    n_real = (keys != _EMPTY).sum(dim=2).tolist()
    for s in range(s_n):
        tks, tvs = tk[s], tv[s]
        for p in range(p_n):
            if not n_real[s][p]:
                continue
            res = kvagg.fpe_aggregate(
                keys[s, p], values[s, p], capacity=capacity, ways=ways,
                op=op, exact_stream=False, table_keys=tks, table_values=tvs)
            tks, tvs = res.table_keys, res.table_values
            idx = (res.evict_keys != _EMPTY).nonzero().squeeze(1)
            ne[s, p] = idx.shape[0]
            idx = idx[:r]  # more than r would break the invariant: checked
            ek[s, p, :idx.shape[0]] = res.evict_keys[idx]
            ev[s, p, :idx.shape[0]] = res.evict_values[idx]
        tk[s], tv[s] = tks, tvs
    return tk, tv, ek, ev, ne


def tier_ingest(keys, values, *, capacity: int, ways: int, op: str,
                bpe: bool, exact_stream: bool, marks=None):
    """Step every switch of one tier through its packet sequence at once.

    ``keys`` is ``[S, P, R]`` int32 (``EMPTY_KEY``-padded), ``values``
    ``[S, P, R, *lanes]`` in the op's carried representation, tensors on
    the device the work runs on.  Returns ``(table_keys [S, C],
    table_values [S, C, *lanes], evict_keys [S, P, R], evict_values
    [S, P, R, *lanes], n_evict [S, P], n_out [S, P])``, ``C`` the
    effective flat table size.  Step *p* of switch *s* is exactly
    ``kvagg.fpe_aggregate(keys[s, p], values[s, p], ...,
    table_keys=<table after step p-1>)`` followed, when ``bpe``, by the
    packet's ``sorted_combine`` (the node engine's sequence): the exact
    stream is one ``fpe_scan_tables`` launch over the S tables, the
    combine one ``sorted_combine_packets`` over the S * P packets.
    ``n_evict`` counts each packet's real evictions (at most R, which
    the caller checks), ``n_out`` its real output entries.  ``marks``,
    three CUDA events or ``None``, are recorded before the FPE step,
    between it and the combine, and after the combine.
    """
    s_n, p_n, r = keys.shape
    lane_shape = tuple(values.shape[3:])
    lanes = math.prod(lane_shape)
    if marks:
        marks[0].record()
    if exact_stream:
        ways, n_buckets, cap = kvagg._fpe_geometry(capacity, ways)
        tk, tv, ek, ev = kv_aggregate.fpe_scan_tables(
            keys.reshape(s_n, p_n * r).contiguous(),
            values.reshape(s_n, p_n * r, lanes).contiguous(),
            n_buckets=n_buckets, ways=ways, op=op)
        tv = tv.reshape((s_n, cap) + lane_shape)
        ek = ek.reshape(s_n, p_n, r)
        ev = ev.reshape((s_n, p_n, r) + lane_shape)
        ne = (ek != _EMPTY).sum(dim=2, dtype=torch.int32)
    else:
        tk, tv, ek, ev, ne = _fast_tier(keys, values, capacity=capacity,
                                        ways=ways, op=op)
    if marks:
        marks[1].record()
    if bpe:  # every packet's eviction combine, one batch
        c = kvagg.sorted_combine_packets(
            ek.reshape(s_n * p_n, r),
            ev.reshape((s_n * p_n, r) + lane_shape), op=op)
        ek = c.unique_keys.reshape(s_n, p_n, r)
        ev = c.combined_values.reshape((s_n, p_n, r) + lane_shape)
    if marks:
        marks[2].record()
    no = (ek != _EMPTY).sum(dim=2, dtype=torch.int32)
    return tk, tv, ek, ev, ne, no


# --------------------------------------------------------------------------
# fast path: packet streams as arrays, whole tiers as numpy passes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PacketStream:
    """One sender edge's packet stream in array form (DESIGN.md §10).

    Packet ``i`` carries ``sizes[i]`` records under PSN ``i`` and is ready
    to transmit at ``times[i]``; the last packet always carries the
    end-of-task flag (every emitter in this simulator closes its stream
    with EoT, on an empty packet if need be).  ``keys``/``values`` are the
    concatenated payloads — ``values`` always has the op's canonical
    ``[N, *lanes]`` carried shape, even when ``N == 0``.
    """

    job_id: int
    flow_id: int
    level: int  # the receiving tier (header ``level`` field)
    times: np.ndarray  # [P] float64 per-packet ready times
    sizes: np.ndarray  # [P] int64 records per packet
    keys: np.ndarray  # [sum(sizes)] int32
    values: np.ndarray  # [sum(sizes), *lanes]
    epoch: int = 0  # restart incarnation stamped on every header (§12)

    @property
    def n_packets(self) -> int:
        return int(self.sizes.shape[0])


def stream_from_records(keys, values, *, t0: float, job_id: int,
                        flow_id: int, level: int, rpp: int,
                        epoch: int = 0) -> PacketStream:
    """A mapper's output stream: ``wire.pack_records`` framing (ceil
    chunks of ``rpp``, trailing EoT, one empty EoT packet for an empty
    stream), all ready at ``t0``."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values)
    n = int(keys.shape[0])
    n_pkts = max(1, -(-n // rpp))
    sizes = np.full((n_pkts,), rpp, np.int64)
    sizes[-1] = n - rpp * (n_pkts - 1)
    return PacketStream(job_id=job_id, flow_id=flow_id, level=level,
                        times=np.full((n_pkts,), float(t0)),
                        sizes=sizes, keys=keys, values=values, epoch=epoch)


def streams_from_mapper_records(keys, values, t0s, *, n_mappers: int,
                                job_id: int, level: int, rpp: int,
                                epoch: int = 0) -> list[PacketStream]:
    """All mapper output streams at once: ``np.array_split`` chunking plus
    per-mapper :func:`stream_from_records`, built from three batched
    arrays instead of ``2 * n_mappers`` numpy calls.  Chunk boundaries,
    packet sizes, and ready times are exactly the per-mapper path's —
    the streams hold views into the same ``keys``/``values`` storage.
    """
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values)
    n = int(keys.shape[0])
    # np.array_split: the first n % m chunks get the extra record
    base, extra = divmod(n, n_mappers)
    chunk = np.full((n_mappers,), base, np.int64)
    chunk[:extra] += 1
    offs = np.concatenate([[0], np.cumsum(chunk)])
    n_pkts = np.maximum(1, -(-chunk // rpp))
    p_offs = np.concatenate([[0], np.cumsum(n_pkts)])
    sizes = np.full((int(p_offs[-1]),), rpp, np.int64)
    sizes[p_offs[1:] - 1] = chunk - rpp * (n_pkts - 1)
    times = np.repeat(np.asarray(t0s, np.float64), n_pkts)
    return [
        PacketStream(job_id=job_id, flow_id=m, level=level,
                     times=times[p_offs[m]:p_offs[m + 1]],
                     sizes=sizes[p_offs[m]:p_offs[m + 1]],
                     keys=keys[offs[m]:offs[m + 1]],
                     values=values[offs[m]:offs[m + 1]], epoch=epoch)
        for m in range(n_mappers)]


def stream_from_packets(stream, *, value_template: np.ndarray) -> PacketStream:
    """Array form of a node-path ``[(t_ready, wire.Packet), ...]`` stream
    (PSN order, trailing EoT).  ``value_template`` supplies the carried
    lane shape/dtype when the stream has no payload at all."""
    hdr0 = stream[0][1].header
    times = np.array([t for t, _ in stream], np.float64)
    sizes = np.array([p.header.n_records for _, p in stream], np.int64)
    ks = [np.asarray(p.keys, np.int32) for _, p in stream
          if p.header.n_records]
    vs = [np.asarray(p.values) for _, p in stream if p.header.n_records]
    keys = (np.concatenate(ks) if ks else np.zeros((0,), np.int32))
    values = (np.concatenate(vs) if vs else value_template[:0])
    return PacketStream(job_id=hdr0.job_id, flow_id=hdr0.flow_id,
                        level=hdr0.level, times=times, sizes=sizes,
                        keys=keys, values=values,
                        epoch=getattr(hdr0, "epoch", 0))


def stream_to_packets(ps: PacketStream) -> list[tuple[float, wire.Packet]]:
    """Materialize ``wire.Packet`` objects — the node-path representation —
    for tiers (disabled/capacity-0) that walk packets one by one."""
    offs = np.concatenate([[0], np.cumsum(ps.sizes)])
    n = ps.n_packets
    out = []
    for i in range(n):
        lo, hi = int(offs[i]), int(offs[i + 1])
        hdr = wire.PacketHeader(
            job_id=ps.job_id, flow_id=ps.flow_id, level=ps.level, psn=i,
            n_records=hi - lo, eot=(i == n - 1), epoch=ps.epoch)
        out.append((float(ps.times[i]),
                    wire.Packet(header=hdr, keys=ps.keys[lo:hi],
                                values=ps.values[lo:hi])))
    return out


def transmit_stream(ps: PacketStream,
                    link: links_lib.Link) -> tuple[np.ndarray, float]:
    """``transport.send_stream`` collapsed to its loss=0 closed form.

    With no drops the window never rewinds and go-back-N is a FIFO chain:
    ``depart_i = max(depart_{i-1}, ready_i) + ser_i`` — evaluated here
    with exactly the node engine's float expressions and order, so depart
    / arrive times and link telemetry are bit-identical.  Returns
    (per-packet arrival times, sender-finished time).
    """
    denom = link.gbps * 1e9  # Link.serialize_s's denominator, precomputed
    prop = link.propagation_s
    t = link.busy_until
    busy_s = link.busy_s
    wire_list = (wire.HEADER_BYTES + ps.sizes * wire.PAIR_BYTES).tolist()
    arrive = np.empty((ps.n_packets,), np.float64)
    i = 0
    for r, wb in zip(ps.times.tolist(), wire_list):
        if t < r:
            t = r
        ser = wb / denom
        t += ser  # start + ser, start = max(prev depart, ready)
        busy_s += ser
        arrive[i] = t + prop
        i += 1
    link.busy_until = t
    link.busy_s = busy_s
    link.bytes_sent += sum(wire_list)
    link.payload_bytes += int(ps.sizes.sum()) * wire.PAIR_BYTES
    link.packets_sent += ps.n_packets
    return arrive, t


def default_timeout_s(gbps: float, propagation_s: float,
                      window: int) -> float:
    """``send_stream``'s conservative RTO — a full window's serialization
    plus one RTT — replicated float op for float op."""
    denom = gbps * 1e9  # Link.serialize_s's denominator
    return 2.0 * (window * (wire.MTU_BYTES / denom) + 2.0 * propagation_s)


@dataclasses.dataclass
class _LinkTransport:
    """One tier's lossy transport leg in array form: accepted-arrival
    times plus the per-link telemetry ``send_stream`` would have accrued
    (all shapes ``[n_links]`` except ``arr``)."""

    arr: np.ndarray  # [n_links, pm] accepted-arrival time per PSN
    dep: np.ndarray  # sender-finished time (= final depart)
    busy: np.ndarray  # serialization occupancy, retransmissions included
    tx: np.ndarray  # transmissions, retransmissions included
    wire_b: np.ndarray  # wire bytes, retransmissions included (int64)
    dropped: np.ndarray
    retx: np.ndarray
    timeouts: np.ndarray
    gaps: np.ndarray  # receiver gap discards (burst survivors past a loss)


def _windowed_transport(*, ready: np.ndarray, wbi: np.ndarray,
                        p_link: np.ndarray, flow_ids: np.ndarray,
                        denom: float, prop: float,
                        loss: transport.LossModel, window: int,
                        timeout_s: float) -> _LinkTransport:
    """Go-back-N under loss for every link of a tier at once.

    ``ready [n_links, pm]`` / ``wbi [n_links, pm]`` are per-PSN ready
    times and wire bytes (padded past ``p_link``); ``denom`` is the
    shared ``gbps * 1e9`` serialization denominator.  Two phases:

    * **control** — a fixed-point loop over burst rounds, every live link
      stepped in lockstep.  A round transmits the ``[n_links, window]``
      rectangle from each link's ``base``; one batched ``drop_array``
      draw (same pure hash as the node sender's per-packet ``drop``)
      decides losses; ``base`` advances to the first loss (go-back-N
      rewind) or past the burst.  Because the transmission schedule
      depends only on the draws — never on timing — acceptance is decided
      here too: slots before the first loss are accepted (they arrive
      with PSN == expected), later survivors are gap discards, and
      duplicates cannot occur (the sender never rewinds past an accepted
      PSN).  Counter telemetry accrues per round.
    * **timing** — replays the recorded rounds transmission by
      transmission with the node sender's float expressions in its
      evaluation order: ``depart = max(depart, ready) + wire/denom`` per
      slot, ``+= timeout_s`` after a lossy burst, accepted arrivals at
      ``depart + prop``.  One vectorized pass per (round, slot) over
      ``[n_links]`` lanes.
    """
    n_links, pm = ready.shape
    w = int(window)
    n_pkts = np.asarray(p_link, np.int64)
    attempts = np.zeros((n_links, pm), np.int64)
    base = np.zeros((n_links,), np.int64)
    live = base < n_pkts
    fl = np.asarray(flow_ids, np.int64)[:, None]
    rows = np.arange(n_links)
    lidx = np.broadcast_to(rows[:, None], (n_links, w))
    slot = np.arange(w)[None, :]
    tx = np.zeros((n_links,), np.int64)
    wire_b = np.zeros((n_links,), np.int64)
    dropped = np.zeros((n_links,), np.int64)
    retx = np.zeros((n_links,), np.int64)
    timeouts = np.zeros((n_links,), np.int64)
    gaps = np.zeros((n_links,), np.int64)
    rounds: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    while live.any():
        upto = np.minimum(base + w, n_pkts)
        psn = base[:, None] + slot
        valid = live[:, None] & (psn < upto[:, None])
        psn_c = np.minimum(psn, pm - 1)  # clipped for safe gathers
        # a (link, psn) pair appears at most once per round, so the
        # unbuffered scatter-add increments each attempt exactly once
        np.add.at(attempts, (lidx[valid], psn[valid]), 1)
        att = np.take_along_axis(attempts, psn_c, axis=1)
        if int(att[valid].max(initial=0)) > transport.MAX_ATTEMPTS:
            raise RuntimeError(
                f"a psn exceeded {transport.MAX_ATTEMPTS} attempts "
                "(loss rate too close to 1?)")
        drop = valid & loss.drop_array(fl, psn_c, att)
        anyd = drop.any(axis=1)
        first = np.where(anyd, drop.argmax(axis=1), w)
        tx += valid.sum(axis=1)
        wire_b += np.where(valid, np.take_along_axis(wbi, psn_c, axis=1),
                           0).sum(axis=1)
        dropped += drop.sum(axis=1)
        retx += (valid & (att > 1)).sum(axis=1)
        timeouts += anyd
        gaps += (valid & ~drop & (slot > first[:, None])).sum(axis=1)
        rounds.append((psn_c, valid, first, anyd))
        base = np.where(live, np.where(anyd, base + first, upto), base)
        live = base < n_pkts
    t = np.zeros((n_links,))
    busy = np.zeros((n_links,))
    arr = np.zeros((n_links, pm))
    for psn_c, valid, first, anyd in rounds:
        for j in range(w):
            v = valid[:, j]
            if not v.any():
                continue
            p = psn_c[:, j]
            ser = wbi[rows, p] / denom
            t = np.where(v, np.maximum(t, ready[rows, p]) + ser, t)
            busy = np.where(v, busy + ser, busy)
            acc = v & (j < first)
            if acc.any():
                arr[acc, p[acc]] = t[acc] + prop
        t = np.where(anyd, t + timeout_s, t)
    return _LinkTransport(arr=arr, dep=t, busy=busy, tx=tx, wire_b=wire_b,
                          dropped=dropped, retx=retx, timeouts=timeouts,
                          gaps=gaps)


def transmit_stream_lossy(
        ps: PacketStream, link: links_lib.Link, loss: transport.LossModel,
        *, window: int, timeout_s: float | None,
) -> tuple[np.ndarray, float, transport.FlowStats, int]:
    """``transport.send_stream`` over one array-form stream under loss:
    :func:`_windowed_transport` with a single link lane.  Fills ``link``
    telemetry, returns (per-PSN accepted-arrival times, sender-finished
    time, flow stats, receiver gap discards)."""
    denom = link.gbps * 1e9
    if timeout_s is None:
        timeout_s = default_timeout_s(link.gbps, link.propagation_s, window)
    sizes = ps.sizes
    lt = _windowed_transport(
        ready=ps.times[None, :],
        wbi=(wire.HEADER_BYTES + sizes * wire.PAIR_BYTES)[None, :],
        p_link=np.array([ps.n_packets], np.int64),
        flow_ids=np.array([ps.flow_id], np.int64), denom=denom,
        prop=link.propagation_s, loss=loss, window=window,
        timeout_s=timeout_s)
    link.busy_until = float(lt.dep[0])
    link.busy_s += float(lt.busy[0])
    link.bytes_sent += int(lt.wire_b[0])
    link.payload_bytes += int(sizes.sum()) * wire.PAIR_BYTES
    link.packets_sent += int(lt.tx[0])
    stats = transport.FlowStats(
        packets_sent=int(lt.tx[0]), packets_dropped=int(lt.dropped[0]),
        retransmissions=int(lt.retx[0]), timeouts=int(lt.timeouts[0]),
        wire_bytes=int(lt.wire_b[0]))
    return lt.arr[0], float(lt.dep[0]), stats, int(lt.gaps[0])


@dataclasses.dataclass
class _Gate:
    """Receiver stand-in: the vectorized transport decides acceptance in
    the window algebra, so only the discard counters survive here.  At
    loss=0 every packet arrives in PSN order and both stay zero; under
    loss the burst survivors past a rewind point land as gap discards.
    Duplicates cannot occur (the sender never rewinds past an accepted
    PSN), matching the node engine's always-zero duplicate counter."""

    gap_discards: int = 0
    duplicate_discards: int = 0


@dataclasses.dataclass
class _TierStats:
    """``LevelState``-shaped telemetry carrier for the fast path."""

    n_evict: int = 0


@dataclasses.dataclass
class _VNode:
    """``_Node``-shaped per-switch result of the fast tier path: same
    telemetry fields, no event-loop state (the arrays already ran)."""

    records_in: int
    records_out: int
    bytes_out: int
    agg_proc_s: float
    queue_peak: int
    state: _TierStats | None  # None on forward-only (relay) tiers
    receiver: _Gate = dataclasses.field(default_factory=_Gate)
    finished: bool = True


@dataclasses.dataclass
class TierWork:
    """One tier's state between :func:`tier_start` and :func:`tier_finish`.

    ``kernel_key`` is the kernel-static signature
    ``(capacity, ways, op, bpe, exact_stream, rpp, lane_shape, dtype)``;
    works sharing it can run in ONE batched ``tier_ingest`` call
    (``None`` on forward-only tiers — they issue no kernel).
    :func:`dispatch_tier_ingest` fills ``kernel_out`` with this work's
    slice of the batch, in host memory: ``(tk [S, C], tv [S, C, *lanes],
    out_k, out_v, ne [S, P], no [S, P])``, where ``out_k``/``out_v`` hold
    the real output entries of the work's switches in (switch, packet,
    slot) order.  ``device`` is where the kernel work runs.
    """

    forward: bool
    level: int
    fanin: int
    job_id: int
    first_flow_id: int
    n_switches: int
    rpp: int
    proc_rate: float
    kernel_key: tuple | None
    # kernel batch scatter (record packets in merged order)
    s_rec: np.ndarray
    dst: np.ndarray
    rows_k: np.ndarray
    rows_v: np.ndarray
    p_counts: np.ndarray
    rec_start: np.ndarray
    # merged arrival schedule (all packets, per-switch (t, flow, psn) order)
    s_m: np.ndarray
    t_m: np.ndarray
    sizes_m: np.ndarray
    eot_m: np.ndarray
    # transport results
    links: list
    flow: transport.FlowStats
    t_done: list[float]
    gaps_sw: np.ndarray  # [n_switches] receiver gap discards
    device: torch.device
    kernel_out: tuple | None = None
    epoch: int = 0  # restart incarnation stamped on the out streams (§12)


def tier_start(streams: list[PacketStream], *, level: int, fanin: int,
               spec: dataplane.LevelSpec | None, op: str, cfg, axis: str,
               gbps: float, job_id: int, first_flow_id: int,
               value_template: np.ndarray,
               loss: transport.LossModel | None = None,
               device: str | torch.device = "cuda") -> TierWork:
    """Run one tier's host-side front half: transport (any loss rate),
    PSN acceptance, the merged arrival schedule, and the kernel batch
    scatter.  Returns a :class:`TierWork` for :func:`dispatch_tier_ingest`
    + :func:`tier_finish`, whose kernel work runs on ``device``.

    ``streams`` holds the child streams in child-index order (child *c* of
    switch *s* at ``streams[s * fanin + c]``).  All per-link transport
    state lives in tier-wide arrays (DESIGN.md §10): at loss=0 the
    serialization recurrence runs once per packet *rank* vectorized over
    every link at the tier; under loss :func:`_windowed_transport` steps
    the go-back-N rounds in lockstep instead.  ``spec=None`` runs the
    tier forward-only (host-only baseline or a placement-disabled hop):
    no kernel, records re-framed unchanged, store-and-forward charged to
    the clock but not to ``agg_proc_s``.  Every float replicates the node
    engine bitwise.
    """
    forward = spec is None
    n_links = len(streams)
    n_switches = n_links // fanin
    rpp = int(cfg.records_per_packet)
    proc_rate = cfg.processing_gbps * 1e9
    lane_shape = value_template.shape[1:]
    vdtype = value_template.dtype
    lossy = loss is not None and loss.rate > 0.0

    # --- transport: every link's go-back-N, batched over the tier ------
    # padded ranks carry ready=-inf, bytes=0 so dead lanes reproduce
    # their last state bit-for-bit
    p_link = np.array([ps.n_packets for ps in streams], np.int64)
    pm_link = int(p_link.max())
    sizes_flat = np.concatenate([ps.sizes for ps in streams])
    big = int(sizes_flat.max(initial=0))
    if big > rpp:
        raise ValueError(f"packet carries {big} records > "
                         f"records_per_packet {rpp}")
    ready = np.full((n_links, pm_link), -np.inf)
    wb = np.zeros((n_links, pm_link))
    lmask = np.arange(pm_link)[None, :] < p_link[:, None]
    ready[lmask] = np.concatenate([ps.times for ps in streams])
    wb[lmask] = wire.HEADER_BYTES + sizes_flat * wire.PAIR_BYTES
    denom = gbps * 1e9  # Link.serialize_s's denominator, precomputed
    starts = np.concatenate([[0], np.cumsum(p_link)[:-1]])
    # every stream has >= 1 packet (an empty stream is one EoT packet),
    # so each reduceat segment is non-empty
    pay_bytes = np.add.reduceat(sizes_flat, starts) * wire.PAIR_BYTES
    flow = transport.FlowStats()
    if lossy:
        window = int(cfg.window)
        timeout_s = (cfg.timeout_s if cfg.timeout_s is not None else
                     default_timeout_s(gbps, cfg.propagation_s, window))
        lt = _windowed_transport(
            ready=ready, wbi=np.where(lmask, wb, 0).astype(np.int64),
            p_link=p_link,
            flow_ids=np.array([ps.flow_id for ps in streams], np.int64),
            denom=denom, prop=cfg.propagation_s, loss=loss, window=window,
            timeout_s=timeout_s)
        dep, busy, arr = lt.dep, lt.busy, lt.arr
        tx_link, wire_link = lt.tx, lt.wire_b
        flow.packets_dropped = int(lt.dropped.sum())
        flow.retransmissions = int(lt.retx.sum())
        flow.timeouts = int(lt.timeouts.sum())
        gaps_sw = lt.gaps.reshape(n_switches, fanin).sum(axis=1)
    else:
        # loss=0: go-back-N never rewinds — the FIFO chain
        # depart_i = max(depart_{i-1}, ready_i) + ser_i per packet rank
        dep = np.zeros((n_links,))
        busy = np.zeros((n_links,))
        arr = np.empty((n_links, pm_link))
        for j in range(pm_link):
            ser = wb[:, j] / denom
            dep = np.maximum(dep, ready[:, j]) + ser
            busy = busy + ser
            arr[:, j] = dep + cfg.propagation_s
        tx_link = p_link
        wire_link = wire.HEADER_BYTES * p_link + pay_bytes
        gaps_sw = np.zeros((n_switches,), np.int64)
    links: list[links_lib.Link] = []
    for c, ps in enumerate(streams):
        link = links_lib.Link(
            name=f"{axis}.s{c // fanin}.c{c % fanin}", axis=axis, gbps=gbps,
            propagation_s=cfg.propagation_s)
        link.busy_until = float(dep[c])
        link.busy_s = float(busy[c])
        link.bytes_sent = int(wire_link[c])
        link.payload_bytes = int(pay_bytes[c])
        link.packets_sent = int(tx_link[c])
        links.append(link)
    flow.packets_sent = int(tx_link.sum())
    flow.wire_bytes = int(wire_link.sum())
    t_done = dep.tolist()

    # --- merge: one global sort keyed (switch, t, flow, psn) — per
    # switch this is the node engine's (t, flow_id, psn) stable order of
    # the ACCEPTED packets (discarded arrivals have no state effects) ---
    s_all = np.repeat(np.arange(n_links) // fanin, p_link)
    t_all = arr[lmask]
    flow_all = np.repeat(np.array([ps.flow_id for ps in streams]), p_link)
    psn_all = np.arange(p_link.sum()) - np.repeat(starts, p_link)
    eot_all = np.zeros(t_all.shape, bool)
    eot_all[np.cumsum(p_link) - 1] = True
    order = np.lexsort((psn_all, flow_all, t_all, s_all))
    s_m, t_m = s_all[order], t_all[order]
    sizes_m = sizes_flat[order]
    eot_m = eot_all[order]

    # payload rows [P_total, rpp] in merged order (record packets only)
    fill = np.arange(rpp)[None, :] < sizes_flat[:, None]
    mat_k = np.full((t_all.shape[0], rpp), _EMPTY, np.int32)
    mat_k[fill] = np.concatenate([ps.keys for ps in streams])
    mat_v = np.zeros((t_all.shape[0], rpp) + lane_shape, vdtype)
    mat_v[fill] = np.concatenate(
        [ps.values for ps in streams if ps.values.shape[0]]
        or [value_template[:0]])
    rec_m = sizes_m > 0
    sel = order[rec_m]  # record packets in merged order, one gather each
    rows_k, rows_v = mat_k[sel], mat_v[sel]
    s_rec = s_m[rec_m]
    p_counts = np.bincount(s_rec, minlength=n_switches)
    rec_start = np.concatenate([[0], np.cumsum(p_counts)[:-1]])
    dst = np.arange(s_rec.shape[0]) - np.repeat(rec_start, p_counts)
    kernel_key = None if forward else (
        spec.capacity, spec.ways, op, spec.bpe, bool(cfg.exact_stream),
        rpp, lane_shape, str(vdtype))
    return TierWork(
        forward=forward, level=level, fanin=fanin, job_id=job_id,
        first_flow_id=first_flow_id, n_switches=n_switches, rpp=rpp,
        proc_rate=proc_rate, kernel_key=kernel_key, s_rec=s_rec, dst=dst,
        rows_k=rows_k, rows_v=rows_v, p_counts=p_counts,
        rec_start=rec_start, s_m=s_m, t_m=t_m, sizes_m=sizes_m,
        eot_m=eot_m, links=links, flow=flow, t_done=t_done,
        gaps_sw=gaps_sw, device=resolve_device(device),
        epoch=int(getattr(cfg, "epoch", 0)))


def batch_arrays(works: list[TierWork]) -> tuple[np.ndarray, np.ndarray]:
    """The ``tier_ingest`` input of works sharing a ``kernel_key``: their
    switches' record packets, in merged arrival order, stacked as keys
    ``[S, P, R]`` and values ``[S, P, R, *lanes]``; ``S`` the works'
    switches in order, ``P`` the most packets a switch got (at least 1),
    shorter switches padded with ``EMPTY_KEY`` packets."""
    _, _, _, _, _, rpp, lane_shape, dt = works[0].kernel_key
    s_n = sum(wk.n_switches for wk in works)
    p_n = max(1, max(int(wk.p_counts.max(initial=0)) for wk in works))
    keys_b = np.full((s_n, p_n, rpp), _EMPTY, np.int32)
    vals_b = np.zeros((s_n, p_n, rpp) + lane_shape, np.dtype(dt))
    off = 0
    for wk in works:
        keys_b[wk.s_rec + off, wk.dst] = wk.rows_k
        vals_b[wk.s_rec + off, wk.dst] = wk.rows_v
        off += wk.n_switches
    return keys_b, vals_b


#: tier_ingest calls issued so far (tests compare the multi-job batcher's
#: call count with the number of shared kernel signatures)
ingest_calls = 0


def dispatch_tier_ingest(works: list[TierWork]) -> int:
    """Run the kernel work of many tiers in as few ``tier_ingest`` calls
    as possible (multi-job tier batching, DESIGN.md §10).

    Works sharing a ``kernel_key`` (and a device) concatenate their
    switches along the batch axis of ONE ``tier_ingest`` call; each work
    gets back its own slice in ``kernel_out``.  The switch tables are
    independent, so every slice is bit-identical to the work's
    standalone call.  The real output entries are compacted on the
    device, so only they, the tables and the per-packet counts are
    copied back.  Returns the number of calls issued.  With the tracer
    on, each call leaves a ``vsim.tier_ingest`` span (see
    :func:`_trace_ingest`).
    """
    global ingest_calls
    tracer = obs_trace.get_tracer()
    groups: dict[tuple, list[TierWork]] = {}
    for wk in works:
        if wk.kernel_key is not None:
            groups.setdefault((wk.kernel_key, wk.device), []).append(wk)
    for (key, dev), ws in groups.items():
        capacity, ways, op, bpe, exact_stream, rpp, _, _ = key
        t0 = time.perf_counter()
        marks = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                 if tracer.enabled and dev.type == "cuda" else None)
        keys_b, vals_b = batch_arrays(ws)
        keys_d = as_tensor(keys_b, dev)
        tk, tv, ek, ev, ne, no = tier_ingest(
            keys_d, as_tensor(vals_b, dev),
            capacity=capacity, ways=ways, op=op, bpe=bpe,
            exact_stream=exact_stream, marks=marks)
        ingest_calls += 1
        ne = ne.cpu().numpy()
        if int(ne.max(initial=0)) > rpp:
            raise AssertionError(
                "tier_ingest eviction compaction dropped real entries "
                f"(a packet evicted {int(ne.max())} > {rpp} pairs)")
        real = ek != _EMPTY
        out_k, out_v = ek[real].cpu().numpy(), ev[real].cpu().numpy()
        tk, tv, no = tk.cpu().numpy(), tv.cpu().numpy(), no.cpu().numpy()
        out_off = np.concatenate([[0], np.cumsum(no.sum(axis=1))])
        off = 0
        for wk in ws:
            sl = slice(off, off + wk.n_switches)
            o = slice(int(out_off[off]), int(out_off[off + wk.n_switches]))
            wk.kernel_out = (tk[sl], tv[sl], out_k[o], out_v[o], ne[sl],
                             no[sl])
            off += wk.n_switches
        if tracer.enabled:
            _trace_ingest(tracer, t0, ws, keys_d, capacity, ways, marks)
    return len(groups)


def _trace_ingest(tracer, t0: float, works: list[TierWork], keys,
                  capacity: int, ways: int, marks) -> None:
    """One wall span for a ``tier_ingest`` call, packing and copies
    included.  Its args: the levels, the batch's shape, its real pairs
    and its longest (switch, bucket) run (what bounds the FPE kernel's
    walk over the tables), and, on a card, the device milliseconds of the
    FPE step (``fpe_tables_ms``) and of the combine (``combine_ms``)."""
    s_n, p_n, r = keys.shape
    _, n_buckets, _ = kvagg._fpe_geometry(capacity, ways)
    flat = keys.reshape(s_n, p_n * r)
    real = flat != _EMPTY
    bkt = aggops.hash_key(flat, n_buckets).long() + n_buckets * torch.arange(
        s_n, device=flat.device)[:, None]
    runs = torch.bincount(bkt[real], minlength=s_n * n_buckets)
    args = {"levels": sorted({wk.level for wk in works}), "switches": s_n,
            "packets": p_n, "slots": s_n * p_n * r,
            "real_pairs": int(real.sum()), "chain_pairs": int(runs.max())}
    if marks:
        args["fpe_tables_ms"] = marks[0].elapsed_time(marks[1])
        args["combine_ms"] = marks[1].elapsed_time(marks[2])
    tracer.add_wall_span("vsim.tier_ingest", t0, time.perf_counter(),
                         cat="sim.device", args=args)


def tier_finish(work: TierWork):
    """Run one tier's host-side back half — the processing-time
    recurrence, EoT flush, MTU re-framing, and telemetry — from a
    :class:`TierWork` whose kernel slice has been dispatched.  Returns
    ``(nodes, out_streams, links, flow_stats, t_done)``: :class:`_VNode`
    telemetry carriers, the per-switch uplink :class:`PacketStream`s, the
    per-edge :class:`~repro_torch.net.links.Link` objects (telemetry filled),
    and each child flow's sender-finished time (the mapper finish times
    at tier 0).
    """
    forward = work.forward
    n_switches = work.n_switches
    fanin = work.fanin
    rpp = work.rpp
    proc_rate = work.proc_rate
    s_m, t_m = work.s_m, work.t_m
    sizes_m, eot_m = work.sizes_m, work.eot_m
    rows_k, rows_v = work.rows_k, work.rows_v
    p_counts, rec_start = work.p_counts, work.rec_start
    if not forward:
        tk, tv, out_k_all, out_v_all, ne, no = work.kernel_out
        out_off = np.concatenate([[0], np.cumsum(no.sum(axis=1))])

    # --- processing-time recurrence (the _Node.receive float ops),
    # batched over switches: one pass per merged-arrival rank -----------
    m_counts = np.bincount(s_m, minlength=n_switches)
    seg_start = np.concatenate([[0], np.cumsum(m_counts)[:-1]])
    psm = int(m_counts.max(initial=0))
    rank = np.arange(s_m.shape[0]) - np.repeat(seg_start, m_counts)
    t_as = np.zeros((n_switches, psm))
    nrec = np.zeros((n_switches, psm), np.int64)
    eots = np.zeros((n_switches, psm), bool)
    t_as[s_m, rank] = t_m
    nrec[s_m, rank] = sizes_m
    eots[s_m, rank] = eot_m
    pf = np.zeros((n_switches,))
    agg_s = np.zeros((n_switches,))
    t_fin = np.zeros((n_switches,))
    tp = np.empty((n_switches, psm))
    if n_switches >= 32:
        # wide tier: one pass per rank, [n_switches]-wide lanes
        cnt = np.zeros((n_switches,), np.int64)
        for j in range(psm):
            live = nrec[:, j] > 0
            busy_j = (wire.HEADER_BYTES + nrec[:, j] * wire.PAIR_BYTES) \
                / proc_rate
            pf = np.where(live, np.maximum(pf, t_as[:, j]) + busy_j, pf)
            if not forward:  # a relay's charge is store-and-forward
                agg_s = np.where(live, agg_s + busy_j, agg_s)
            tp[:, j] = pf
            t_j = np.where(live, pf, t_as[:, j])
            cnt = cnt + eots[:, j]
            hit = eots[:, j] & (cnt == fanin)
            t_fin = np.where(hit, np.maximum(t_j, pf), t_fin)
    else:
        # narrow tier (few switches, long streams): python scalars beat
        # width-1 numpy lanes by ~10x; identical float ops either way
        for s in range(n_switches):
            m = int(m_counts[s])
            pf_s = 0.0
            agg = 0.0
            eots_s = 0
            fin = 0.0
            tp_row = tp[s]
            for j, (t_a, nr, eot) in enumerate(zip(
                    t_as[s, :m].tolist(), nrec[s, :m].tolist(),
                    eots[s, :m].tolist())):
                t = t_a
                if nr:
                    start = pf_s if pf_s > t_a else t_a
                    busy_j = (wire.HEADER_BYTES + nr * wire.PAIR_BYTES) \
                        / proc_rate
                    pf_s = start + busy_j
                    if not forward:
                        agg += busy_j
                    t = pf_s
                tp_row[j] = pf_s
                if eot:
                    eots_s += 1
                    if eots_s == fanin:
                        fin = pf_s if pf_s > t else t
            pf[s] = pf_s
            agg_s[s] = agg
            t_fin[s] = fin
    # --- EoT flush (the _Node._finish float ops; relays hold no table)
    if forward:
        flush_ns = np.zeros((n_switches,), np.int64)
        t_end_v = t_fin
    else:
        flush_m = tk[:n_switches] != _EMPTY
        flush_ns = flush_m.sum(axis=1).astype(np.int64)
        busy_f = flush_ns * wire.PAIR_BYTES / proc_rate
        flushed = flush_ns > 0
        agg_s = np.where(flushed, agg_s + busy_f, agg_s)
        t_end_v = np.where(flushed, np.maximum(t_fin, pf) + busy_f, t_fin)

    nodes: list[_VNode] = []
    out_streams: list[PacketStream] = []
    for s in range(n_switches):
        pc = int(p_counts[s])
        mrow = slice(int(seg_start[s]), int(seg_start[s]) + int(m_counts[s]))
        live_row = nrec[s, :m_counts[s]] > 0
        if forward:
            out_counts = nrec[s, :m_counts[s]][live_row]
        else:
            out_counts = no[s, :pc].astype(np.int64)
        flush_n = int(flush_ns[s])
        t_end = float(t_end_v[s])
        # --- MTU re-framing: frame j closes at the arrival whose output
        # pushed the pending queue past (j+1)*rpp; the rest flush at EoT
        cumout = np.cumsum(out_counts)
        total = int(cumout[-1]) if pc else 0
        total_after = total + flush_n
        k1 = total // rpp
        k_total = total_after // rpp
        rem = total_after - k_total * rpp
        frame_t = np.full((k_total + 1,), t_end, np.float64)
        if k1:
            idx = np.searchsorted(cumout,
                                  np.arange(1, k1 + 1) * rpp, side="left")
            frame_t[:k1] = tp[s, :m_counts[s]][live_row][idx]
        frame_sizes = np.full((k_total + 1,), rpp, np.int64)
        frame_sizes[-1] = rem  # the EoT frame (empty when rem == 0)
        # --- payload: forwarded records, or per-packet eviction streams
        # followed by the table flush ---
        seg = slice(int(rec_start[s]), int(rec_start[s]) + pc)
        if forward:
            fwd = np.arange(rpp)[None, :] < out_counts[:, None]
            out_k, out_v = rows_k[seg][fwd], rows_v[seg][fwd]
        else:
            seg_o = slice(int(out_off[s]), int(out_off[s + 1]))
            out_k, out_v = out_k_all[seg_o], out_v_all[seg_o]
            if flush_n:
                out_k = np.concatenate([out_k, tk[s][flush_m[s]]])
                out_v = np.concatenate([out_v, tv[s][flush_m[s]]])
        assert out_k.shape[0] == total_after
        # --- telemetry (matches _Node counter for counter) ---
        pend_before = (cumout - out_counts) % rpp
        peaks = (pend_before + out_counts)[out_counts > 0]
        peak = int(peaks.max()) if peaks.size else 0
        if flush_n:
            peak = max(peak, total % rpp + flush_n)
        nodes.append(_VNode(
            records_in=int(sizes_m[mrow].sum()),
            records_out=total_after,
            bytes_out=((k_total + 1) * wire.HEADER_BYTES
                       + total_after * wire.PAIR_BYTES),
            agg_proc_s=float(agg_s[s]),
            queue_peak=peak,
            state=None if forward else _TierStats(
                n_evict=int(ne[s, :pc].sum())),
            receiver=_Gate(gap_discards=int(work.gaps_sw[s])),
        ))
        out_streams.append(PacketStream(
            job_id=work.job_id, flow_id=work.first_flow_id + s,
            level=work.level + 1, times=frame_t, sizes=frame_sizes,
            keys=out_k.astype(np.int32), values=out_v, epoch=work.epoch))
    return nodes, out_streams, work.links, work.flow, work.t_done


def run_tier_fast(streams: list[PacketStream], *, level: int, fanin: int,
                  spec: dataplane.LevelSpec | None, op: str, cfg, axis: str,
                  gbps: float, job_id: int, first_flow_id: int,
                  value_template: np.ndarray,
                  loss: transport.LossModel | None = None,
                  device: str | torch.device = "cuda"):
    """Run one whole tier — transport (any loss rate), acceptance,
    processing, MTU re-framing, telemetry — arrays plus (at most) one
    kernel call: :func:`tier_start` → :func:`dispatch_tier_ingest` →
    :func:`tier_finish` for a single tier, the kernel work on ``device``.
    See those for the contract; the sim's lockstep batch driver runs the
    trio directly so concurrent jobs' tiers can share kernel batches."""
    work = tier_start(
        streams, level=level, fanin=fanin, spec=spec, op=op, cfg=cfg,
        axis=axis, gbps=gbps, job_id=job_id, first_flow_id=first_flow_id,
        value_template=value_template, loss=loss, device=device)
    dispatch_tier_ingest([work])
    return tier_finish(work)
