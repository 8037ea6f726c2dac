"""Discrete-event job simulator: mappers -> switch cascade -> reducer
(DESIGN.md §7; paper §6 Figs. 9-10), ported to torch (counterpart of
``repro/net/sim.py``).

The missing layer between the planner and the dataplane: the planner
*models* per-level bytes and drain times, the dataplane *computes* exact
aggregation — this module runs a whole job over an emulated network and
measures what the paper measures: job completion time, per-link wire
bytes, and drain time, with or without in-network aggregation.

Topology: ``fanins`` leaf->root (e.g. ``(4, 2)`` = 8 mappers, two level-0
switches of fan-in 4, one root of fan-in 2).  Every tree edge is its own
FIFO :class:`~repro_torch.net.links.Link`; every edge runs a reliable go-back-N
flow (``net.transport``) whose receiver dedupes on PSN before the records
touch aggregation state.  Each switch owns one ``dataplane.LevelState``
node (its slice of the job's ``CascadePlan``), charges line-rate
processing per packet, re-packs its eviction stream into MTU frames
(``net.wire``) as it goes, and flushes downstream once every child has
sent end-of-task.  The root's stream crosses the reducer in-link — the
paper testbed's 10 GbE bottleneck — and JCT is the arrival of the final
end-of-task byte at the reducer.

Because links are FIFO and flows are per-edge, the engine runs level by
level: a node's full arrival schedule is known once its children finished,
so no global event heap is needed — arrivals are merged in time order and
ingested sequentially, which keeps the hash-table dynamics honest.

Concurrency: :func:`_simulate_jobs` steps a whole batch of independent
jobs level by level in lockstep, so tiers at the same depth that share a
kernel-static signature run as ONE batched ``vsim.tier_ingest`` call
(multi-job tier batching, DESIGN.md §10) — results are bit-identical to
running each job alone.

``aggregate=False`` is the host-only baseline: switches forward records
unaggregated and the reducer in-link carries the entire map output — the
configuration the paper's Fig. 10 JCT comparison is measured against.

Device: the table work (each switch's ``LevelState`` on the node engine,
the tier kernels on the vectorized one, the reducer's final merge) runs
on the ``device`` a run is given; the host arithmetic (transport,
timing, re-framing, telemetry) is numpy, as in the JAX package.

Not ported yet: the fault plane (the epoch-restart driver), the fat-tree
and ``JobPlan`` paths (they need ``core.planner`` and the controller),
and the deprecated ``simulate_job*`` entry points.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import aggops, dataplane, kvagg
from repro_torch.obs import trace as obs_trace
from . import links as links_lib
from . import schema as schema_lib
from . import transport, vsim, wire

_EMPTY = int(kvagg.EMPTY_KEY)


def _host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Device tensors -> numpy arrays on the host."""
    return tuple(t.cpu().numpy() for t in tensors)


def _as_jax_default_dtype(values: np.ndarray) -> np.ndarray:
    """The dtype ``jnp.asarray`` gives an array outside 64-bit mode, as
    the JAX package's sims run: float64 -> float32, int64 -> int32."""
    if values.dtype == np.float64:
        return values.astype(np.float32)
    if values.dtype == np.int64:
        return values.astype(np.int32)
    return values

#: paper-testbed defaults, in the planner's 1e9-bytes/s unit
TEN_GBE = 1.25  # 10 GbE link
LINE_RATE = 5.0  # 40 Gb/s processing engine


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Knobs of the emulated network (defaults: the paper's testbed)."""

    link_gbps: tuple[float, ...] | None = None  # per tree level, leaf->root
    reducer_gbps: float | None = None  # reducer in-link; default root level
    processing_gbps: float = LINE_RATE  # switch line-rate processing charge
    propagation_s: float = 1e-6
    loss_rate: float = 0.0
    seed: int = 0
    window: int = 16  # go-back-N window
    timeout_s: float | None = None  # None: per-link conservative RTO
    records_per_packet: int = wire.RECORDS_PER_PACKET
    #: False runs every switch FPE on the batched-block fast path
    #: (DESIGN.md §8): same delivered totals, eviction traffic not
    #: paper-faithful — keep True for Fig. 9/10 reproductions
    exact_stream: bool = True
    #: "node" steps one Python node per switch (the oracle);
    #: "vectorized" batches each tier's per-packet FPE work into one
    #: kernel launch (DESIGN.md §10) — bit-identical results at any loss
    #: rate
    engine: str = "node"
    #: optional ``transport.LossModel`` override (e.g. an explicit
    #: drop-mask model in the property tests); ``None`` builds
    #: ``LossModel(loss_rate, seed)``.  The model's ``rate`` must be > 0
    #: for the lossy transport path to engage, and its ``drop`` /
    #: ``drop_array`` must stay elementwise-consistent so both engines
    #: see the same loss pattern.
    loss_model: transport.LossModel | None = None
    #: restart incarnation stamped on every packet header (DESIGN.md §12);
    #: 0 outside a fault driver (not ported yet)
    epoch: int = 0

    def __post_init__(self):
        if self.engine not in ("node", "vectorized"):
            raise ValueError(f"unknown sim engine {self.engine!r} "
                             "(expected 'node' or 'vectorized')")
        if not 0.0 <= self.loss_rate < 1.0:
            raise ValueError(f"loss_rate {self.loss_rate!r} outside [0, 1)")


class _Node:
    """One switch: PSN-dedupe gate + one cascade level + output packetizer."""

    def __init__(self, *, level: int, n_children: int,
                 spec: dataplane.LevelSpec | None, op: str, aggregate: bool,
                 cfg: NetConfig, job_id: int, flow_id: int,
                 device: torch.device):
        self.level = level
        self.n_children = n_children
        # a disabled spec (placement left this tier out, DESIGN.md §9) is a
        # forward-only switch — same path as the host-only baseline
        self.aggregate = aggregate and (spec is None or spec.enabled)
        self.state = (dataplane.LevelState(
            spec, op, batch_pad=cfg.records_per_packet,
            exact_stream=cfg.exact_stream, device=device)
            if self.aggregate else None)
        self.receiver = transport.Receiver()
        self.proc_free = 0.0
        self.proc_rate = cfg.processing_gbps * 1e9
        self.rpp = cfg.records_per_packet
        self.job_id = job_id
        self.epoch = int(cfg.epoch)
        self.flow_id = flow_id  # of the uplink flow this node sends
        self.out: list[tuple[float, wire.Packet]] = []  # (t_ready, pkt)
        self._psn = 0
        self._pend_k: np.ndarray | None = None
        self._pend_v: np.ndarray | None = None
        self._eot_seen = 0
        self.records_in = 0
        self.records_out = 0
        self.bytes_out = 0  # wire bytes of every packet this node emits
        self.agg_proc_s = 0.0  # aggregation-engine busy seconds (0 if relay)
        self.queue_peak = 0  # deepest the output pending queue ever got
        self.finished = False
        # fault-plane timing: when the table first held state and when the
        # EoT flush completed — the window a table_wipe can corrupt (§12)
        self.t_first_ingest = math.inf
        self.t_finish = math.inf

    def _append(self, keys: np.ndarray, values: np.ndarray) -> None:
        if self._pend_k is None:
            self._pend_k, self._pend_v = keys, values
        else:
            self._pend_k = np.concatenate([self._pend_k, keys])
            self._pend_v = np.concatenate([self._pend_v, values])
        self.queue_peak = max(self.queue_peak, int(self._pend_k.shape[0]))

    def _emit_packet(self, t: float, keys: np.ndarray, values: np.ndarray,
                     eot: bool) -> None:
        hdr = wire.PacketHeader(
            job_id=self.job_id, flow_id=self.flow_id, level=self.level + 1,
            psn=self._psn, n_records=int(keys.shape[0]), eot=eot,
            epoch=self.epoch)
        self._psn += 1
        self.records_out += int(keys.shape[0])
        pkt = wire.Packet(header=hdr, keys=keys, values=values)
        self.bytes_out += pkt.wire_bytes
        self.out.append((t, pkt))

    def _emit_full(self, t: float) -> None:
        while self._pend_k is not None and self._pend_k.shape[0] >= self.rpp:
            k, self._pend_k = self._pend_k[:self.rpp], self._pend_k[self.rpp:]
            v, self._pend_v = self._pend_v[:self.rpp], self._pend_v[self.rpp:]
            self._emit_packet(t, k, v, eot=False)

    def receive(self, pkt: wire.Packet, t_arrive: float) -> None:
        """Ingest one arrival: dedupe on PSN, charge line-rate processing,
        cascade the records, and re-frame whatever leaves the node."""
        if not self.receiver.accept(pkt.header):
            return  # gap or duplicate: discarded before aggregation state
        t = t_arrive
        if pkt.header.n_records:
            start = max(t_arrive, self.proc_free)
            busy = pkt.wire_bytes / self.proc_rate
            self.proc_free = start + busy
            t = self.proc_free
            if self.aggregate:  # a relay's charge is store-and-forward,
                self.agg_proc_s += busy  # not aggregation-engine work
            self.records_in += pkt.header.n_records
            self.t_first_ingest = min(self.t_first_ingest, t_arrive)
            if self.aggregate:
                ek, ev = _host(*self.state.ingest(pkt.keys, pkt.values))
            else:  # host-only baseline: forward unaggregated
                ek = np.asarray(pkt.keys, np.int32)
                ev = np.asarray(pkt.values)
            if ek.shape[0]:
                self._append(ek, ev)
                self._emit_full(t)
        if pkt.header.eot:
            self._eot_seen += 1
            if self._eot_seen == self.n_children:
                self._finish(max(t, self.proc_free))

    def _finish(self, t: float) -> None:
        if self.aggregate:
            fk, fv = _host(*self.state.flush())
            if fk.shape[0]:
                # EoT flush streams out at the processing line rate too
                busy = fk.shape[0] * wire.PAIR_BYTES / self.proc_rate
                self.agg_proc_s += busy
                self.proc_free = max(t, self.proc_free) + busy
                t = self.proc_free
                self._append(fk, fv)
        self._emit_full(t)
        if self._pend_k is not None and self._pend_k.shape[0]:
            self._emit_packet(t, self._pend_k, self._pend_v, eot=True)
            self._pend_k = self._pend_v = None
        else:  # the flush trigger must cross the wire even when empty
            self._emit_packet(
                t, np.zeros((0,), np.int32),
                np.zeros((0,), np.float32), eot=True)
        self.t_finish = t
        self.finished = True


@dataclasses.dataclass
class SimResult:
    """Everything one simulated job run measured."""

    jct_s: float
    aggregate: bool
    op: str
    fanins: tuple[int, ...]
    axes: tuple[str, ...]
    delivered_keys: np.ndarray  # reducer's final table, packed + finalized
    delivered_values: np.ndarray
    delivered_records: int  # records the reducer hands the application
    delivered_bytes: int  # wire bytes of the delivered stream
    arrived_records: int  # records arriving at the reducer pre-merge
    link_stats: dict[str, dict]  # per axis (+ "reducer"), links.stats_by_axis
    per_level: list[dict]
    retransmissions: int
    timeouts: int
    packets_dropped: int
    gap_discards: int
    duplicate_discards: int
    mapper_finish_s: list[float]

    def delivered_table(self) -> dict[int, float]:
        return {int(k): np.asarray(v).tolist() if np.ndim(v) else float(v)
                for k, v in zip(self.delivered_keys, self.delivered_values)}

    def report(self) -> dict:
        """JSON-able record in the unified schema (``net.schema``) —
        identical keys from both engines, bench/dry-run/dashboard shape."""
        return schema_lib.report_dict(self)


def _default_axes(n: int) -> tuple[str, ...]:
    return tuple(f"lvl{i}" for i in range(n))


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job's inputs to ``net.simulate`` as data, so a batch of
    concurrent jobs can run through the level-lockstep engine together."""

    keys: object
    values: object
    fanins: Sequence[int]
    plan: dataplane.CascadePlan | None = None
    op: str = "sum"
    aggregate: bool = True
    cfg: NetConfig | None = None
    axes: Sequence[str] | None = None
    mapper_delay: Callable[[int], float] | None = None
    job_id: int = 0
    #: telemetry tag: labels this job's metric series and names its trace
    #: track (placement policy, comparison leg, ...); default "job<id>"
    tag: str = ""

    def __post_init__(self):
        fanins = tuple(int(f) for f in self.fanins)
        if not fanins or any(f < 1 for f in fanins):
            raise ValueError(f"bad fanins {fanins}: every level needs a "
                             "positive mapper/child count")


class _JobRun:
    """Mutable per-job state while :func:`_simulate_jobs` steps the batch
    level by level.  Jobs never interact — each owns its links, flows,
    and streams; the lockstep exists only so same-depth tiers can share
    batched kernel calls."""

    def __init__(self, spec: JobSpec, device: torch.device):
        cfg = spec.cfg or NetConfig()
        # engine/loss-rate/fanin validity is a dataclass invariant now:
        # NetConfig.__post_init__ and JobSpec.__post_init__ raise at
        # construction, before any simulation state exists
        fanins = tuple(int(f) for f in spec.fanins)
        n_levels = len(fanins)
        axes = (tuple(spec.axes) if spec.axes is not None
                else _default_axes(n_levels))
        if len(axes) != n_levels:
            raise ValueError("axes must match fanins")
        op, plan, aggregate = spec.op, spec.plan, spec.aggregate
        if plan is not None:
            op = plan.op  # the plan owns the op even for the baseline
        if aggregate:
            if plan is None:
                plan = dataplane.CascadePlan(op=op, levels=tuple(
                    dataplane.LevelSpec(capacity=0) for _ in fanins))
            if len(plan.levels) != n_levels:
                raise ValueError(
                    f"plan has {len(plan.levels)} levels, tree has "
                    f"{n_levels}")
        link_gbps = (tuple(cfg.link_gbps) if cfg.link_gbps is not None
                     else (TEN_GBE,) * n_levels)
        if len(link_gbps) != n_levels:
            raise ValueError("link_gbps must match fanins")
        self.cfg = cfg
        self.fanins = fanins
        self.n_levels = n_levels
        self.axes = axes
        self.op = op
        self.plan = plan
        self.aggregate = aggregate
        self.aggop = aggops.get(op)
        self.link_gbps = link_gbps
        self.reducer_gbps = (cfg.reducer_gbps if cfg.reducer_gbps is not None
                             else link_gbps[-1])
        self.job_id = spec.job_id
        self.tag = spec.tag or f"job{spec.job_id}"
        self.device = device
        # one virtual-time trace track per run (DESIGN.md §11): per-level
        # ingest/transport lanes on their own pid so repeated runs and
        # concurrent jobs never interleave on one lane
        tracer = obs_trace.get_tracer()
        self._pid: int | None = None
        if tracer.enabled:
            leg = "" if spec.aggregate else " (host-only)"
            self._pid = tracer.new_track(f"sim {self.tag}{leg}")

        n_mappers = math.prod(fanins)
        self.keys = np.asarray(spec.keys, np.int32)
        self.carried = self.aggop.prepare_values(torch.from_numpy(
            _as_jax_default_dtype(np.array(spec.values)))).numpy()
        self.loss = (cfg.loss_model if cfg.loss_model is not None
                     else transport.LossModel(cfg.loss_rate, cfg.seed))
        self.all_links: list[links_lib.Link] = []
        self.flows = transport.FlowStats()
        self.mapper_finish = [0.0] * n_mappers
        self.fast_engine = cfg.engine == "vectorized"
        self.next_flow_id = n_mappers
        self.per_level_nodes: list[list] = []
        self.reducer_gap = 0
        self.reducer_dup = 0

        # mapper output flows (flow ids 0..n_mappers-1); streams live as
        # Packet lists (node path) or array-form PacketStreams (fast path)
        t0s = [float(spec.mapper_delay(m)) if spec.mapper_delay is not None
               else 0.0 for m in range(n_mappers)]
        if self.fast_engine:
            self.current: list = vsim.streams_from_mapper_records(
                self.keys, self.carried, t0s, n_mappers=n_mappers,
                job_id=self.job_id, level=0, rpp=cfg.records_per_packet,
                epoch=int(cfg.epoch))
        else:
            key_chunks = np.array_split(self.keys, n_mappers)
            val_chunks = np.array_split(self.carried, n_mappers)
            self.current = []
            for m in range(n_mappers):
                pkts = wire.pack_records(
                    key_chunks[m], val_chunks[m], job_id=self.job_id,
                    flow_id=m, level=0, eot=True,
                    records_per_packet=cfg.records_per_packet,
                    epoch=int(cfg.epoch))
                self.current.append([(t0s[m], p) for p in pkts])

    def _note_tier(self, l: int, *, t0: float, t1: float,
                   kind: str) -> None:
        """Replay one tier interval onto this run's virtual-time track
        (span taxonomy: ``sim.transport`` = child flows draining,
        ``sim.ingest`` = switch accept/aggregate/re-frame window)."""
        tracer = obs_trace.get_tracer()
        if not tracer.enabled or self._pid is None:
            return
        tid = 2 * l + (1 if kind == "ingest" else 0)
        name = f"L{l} {self.axes[l]} {kind}"
        tracer.name_thread(self._pid, tid, name)
        tracer.add_span(name, t0, t1, cat=f"sim.{kind}", pid=self._pid,
                        tid=tid, args={"level": l, "axis": self.axes[l]})

    def _add_flow(self, st: transport.FlowStats) -> None:
        self.flows.packets_sent += st.packets_sent
        self.flows.packets_dropped += st.packets_dropped
        self.flows.retransmissions += st.retransmissions
        self.flows.timeouts += st.timeouts
        self.flows.wire_bytes += st.wire_bytes

    def _run_flow(self, stream, link, sink) -> float:
        arrivals: list[tuple[float, wire.Packet]] = []
        fid = stream[0][1].header.flow_id
        t_done, st = transport.send_stream(
            stream, link, self.loss, flow_id=fid, window=self.cfg.window,
            timeout_s=self.cfg.timeout_s,
            deliver=lambda p, t: arrivals.append((t, p)))
        self._add_flow(st)
        sink.extend(arrivals)
        return t_done

    def start_tier(self, l: int) -> vsim.TierWork | None:
        """Run tier *l*'s front half.  Fast-path tiers return a
        ``TierWork`` for the shared kernel dispatch; node-path tiers
        (host-only engine, or capacity-0 exact levels) run to completion
        here and return ``None``."""
        spec = self.plan.levels[l] if self.aggregate else None
        # forward-only tiers (host-only baseline, placement-disabled hops)
        # have no aggregation state at all, so the fast path covers them
        # with pure array re-framing — no kernel call
        fast_forward = self.fast_engine and (
            not self.aggregate or (spec is not None and not spec.enabled))
        if fast_forward or (self.fast_engine and self.aggregate
                            and vsim.supports(spec)):
            # fast path (DESIGN.md §10): the whole tier — transport (any
            # loss rate), acceptance, processing, re-framing, telemetry —
            # as array passes plus at most one batched table step,
            # bit-identical to the node walk
            streams = [
                s if isinstance(s, vsim.PacketStream)
                else vsim.stream_from_packets(
                    s, value_template=self.carried[:0])
                for s in self.current]
            return vsim.tier_start(
                streams, level=l, fanin=self.fanins[l],
                spec=None if fast_forward else spec, op=self.op,
                cfg=self.cfg, axis=self.axes[l], gbps=self.link_gbps[l],
                job_id=self.job_id, first_flow_id=self.next_flow_id,
                value_template=self.carried[:0], loss=self.loss,
                device=self.device)
        self._run_tier_node(l)
        return None

    def finish_tier(self, l: int, work: vsim.TierWork) -> None:
        """Consume tier *l*'s dispatched kernel slice and advance."""
        nodes, out_streams, tier_links, tier_flow, t_done = \
            vsim.tier_finish(work)
        self.next_flow_id += work.n_switches
        self.all_links.extend(tier_links)
        self._add_flow(tier_flow)
        if l == 0:
            self.mapper_finish = list(t_done)
        self.per_level_nodes.append(nodes)
        self.current = out_streams
        if self._pid is not None and obs_trace.get_tracer().enabled:
            t0 = float(work.t_m.min()) if work.t_m.size else 0.0
            t_tx = max(t_done, default=t0)
            self._note_tier(l, t0=t0, t1=t_tx, kind="transport")
            t_out = max((float(s.times[-1]) for s in out_streams
                         if s.times.size), default=t_tx)
            self._note_tier(l, t0=t0, t1=t_out, kind="ingest")

    def _run_tier_node(self, l: int) -> None:
        # node path tiers (host-only engine, capacity-0 exact levels)
        # walk materialized packets
        fanin = self.fanins[l]
        n_switches = math.prod(self.fanins[l + 1:])
        spec = self.plan.levels[l] if self.aggregate else None
        current = [
            vsim.stream_to_packets(s) if isinstance(s, vsim.PacketStream)
            else s for s in self.current]
        nodes: list[_Node] = []
        nxt: list[list[tuple[float, wire.Packet]]] = []
        t_first, t_tx, t_out = math.inf, 0.0, 0.0
        for s in range(n_switches):
            # phase A — transport: run every child-edge flow; links are
            # FIFO and flows per-edge, so the switch's full arrival
            # schedule is known before its node steps
            arrivals: list[tuple[float, wire.Packet]] = []
            for c in range(fanin):
                ci = s * fanin + c
                link = links_lib.Link(
                    name=f"{self.axes[l]}.s{s}.c{c}", axis=self.axes[l],
                    gbps=self.link_gbps[l],
                    propagation_s=self.cfg.propagation_s)
                self.all_links.append(link)
                t_done = self._run_flow(current[ci], link, arrivals)
                t_tx = max(t_tx, t_done)
                if l == 0:
                    self.mapper_finish[ci] = t_done
            arrivals.sort(key=lambda a: (a[0], a[1].header.flow_id,
                                         a[1].header.psn))
            # phase B — host walk: acceptance, aggregation, timing,
            # packetization, and telemetry through the node code
            node = _Node(level=l, n_children=fanin, spec=spec, op=self.op,
                         aggregate=self.aggregate, cfg=self.cfg,
                         job_id=self.job_id, flow_id=self.next_flow_id,
                         device=self.device)
            self.next_flow_id += 1
            for t, p in arrivals:
                node.receive(p, t)
            assert node.finished, "reliable transport must complete the node"
            nodes.append(node)
            nxt.append(node.out)
            if arrivals:
                t_first = min(t_first, arrivals[0][0])
            if node.out:
                t_out = max(t_out, max(t for t, _ in node.out))
        self.per_level_nodes.append(nodes)
        self.current = nxt
        if self._pid is not None and obs_trace.get_tracer().enabled:
            t0 = 0.0 if math.isinf(t_first) else t_first
            self._note_tier(l, t0=t0, t1=max(t_tx, t0), kind="transport")
            self._note_tier(l, t0=t0, t1=max(t_out, t0), kind="ingest")

    def finalize(self) -> SimResult:
        """Root -> reducer over the reducer in-link, then assemble."""
        cfg = self.cfg
        red_link = links_lib.Link(name="reducer", axis="reducer",
                                  gbps=self.reducer_gbps,
                                  propagation_s=cfg.propagation_s)
        self.all_links.append(red_link)
        root = self.current[0]
        if isinstance(root, vsim.PacketStream):
            # fast path: acceptance falls out of the window algebra, so
            # the reducer's pre-merge stream is the root stream verbatim
            # and the JCT is the last accepted arrival
            if self.loss.rate > 0.0:
                arrive, _, st, self.reducer_gap = vsim.transmit_stream_lossy(
                    root, red_link, self.loss, window=cfg.window,
                    timeout_s=cfg.timeout_s)
                self._add_flow(st)
            else:
                arrive, _ = vsim.transmit_stream(root, red_link)
                self.flows.packets_sent += root.n_packets
                self.flows.wire_bytes += (
                    wire.HEADER_BYTES * root.n_packets
                    + wire.PAIR_BYTES * int(root.sizes.sum()))
            jct = max(0.0, float(arrive.max()))
            arrived_k, arrived_v = root.keys, root.values
        else:
            recv = transport.Receiver()
            arrivals: list[tuple[float, wire.Packet]] = []
            self._run_flow(root, red_link, arrivals)
            arrivals.sort(key=lambda a: (a[0], a[1].header.psn))
            jct = 0.0
            rec_k: list[np.ndarray] = []
            rec_v: list[np.ndarray] = []
            for t, p in arrivals:
                if recv.accept(p.header):
                    jct = max(jct, t)
                    if p.header.n_records:
                        rec_k.append(np.asarray(p.keys, np.int32))
                        rec_v.append(np.asarray(p.values))
            arrived_k = (np.concatenate(rec_k) if rec_k
                         else np.zeros((0,), np.int32))
            arrived_v = (np.concatenate(rec_v) if rec_v
                         else np.zeros((0,) + self.carried.shape[1:],
                                       self.carried.dtype))
            self.reducer_gap = recv.gap_discards
            self.reducer_dup = recv.duplicate_discards
        if arrived_k.size:  # the reducer host's final exact merge
            c = kvagg.sorted_combine(as_tensor(arrived_k, self.device),
                                     as_tensor(arrived_v, self.device),
                                     op=self.op)
            n_unique = int(c.n_unique)
            dk, dv = _host(c.unique_keys[:n_unique],
                           self.aggop.finalize_values(
                               c.combined_values[:n_unique]))
        else:
            n_unique, dk = 0, np.zeros((0,), np.int32)
            dv = np.zeros((0,), np.float32)

        gap = sum(n.receiver.gap_discards
                  for lvl in self.per_level_nodes for n in lvl) \
            + self.reducer_gap
        dup = sum(n.receiver.duplicate_discards
                  for lvl in self.per_level_nodes for n in lvl) \
            + self.reducer_dup
        per_level = [schema_lib.level_report(l, self.axes[l], nodes)
                     for l, nodes in enumerate(self.per_level_nodes)]
        result = SimResult(
            jct_s=jct,
            aggregate=self.aggregate,
            op=self.op,
            fanins=self.fanins,
            axes=self.axes,
            delivered_keys=dk,
            delivered_values=dv,
            delivered_records=n_unique,
            delivered_bytes=wire.stream_wire_bytes(
                n_unique, cfg.records_per_packet),
            arrived_records=int(arrived_k.shape[0]),
            link_stats=links_lib.stats_by_axis(self.all_links),
            per_level=per_level,
            retransmissions=self.flows.retransmissions,
            timeouts=self.flows.timeouts,
            packets_dropped=self.flows.packets_dropped,
            gap_discards=gap,
            duplicate_discards=dup,
            mapper_finish_s=self.mapper_finish,
        )
        # telemetry out (DESIGN.md §11): both engines publish through the
        # one schema path, so their metric series are comparable 1:1
        schema_lib.publish_report(result.report(), job=self.tag,
                                  engine=self.cfg.engine)
        tracer = obs_trace.get_tracer()
        if tracer.enabled and self._pid is not None:
            root_t0 = 0.0
            if isinstance(root, vsim.PacketStream):
                if root.times.size:
                    root_t0 = float(root.times[0])
            elif root:
                root_t0 = float(root[0][0])
            tid = 2 * self.n_levels
            tracer.name_thread(self._pid, tid, "reducer drain")
            tracer.add_span("reducer drain", root_t0, max(jct, root_t0),
                            cat="sim.transport", pid=self._pid, tid=tid,
                            args={"axis": "reducer"})
        return result


def _simulate_jobs(
    specs: Sequence[JobSpec],
    admissions: Sequence[tuple[int, JobSpec]] = (),
    *,
    device: torch.device,
) -> list[SimResult]:
    """The level-lockstep batch engine, with event-driven mid-run
    admission.  ``specs`` start at lockstep step 0; each ``(step, spec)``
    in ``admissions`` joins the running batch at that lockstep step —
    i.e. between tier levels of the jobs already in flight — and a job
    leaves the batch the step its last tier completes.  Jobs never
    interact (each owns its links, flows, and streams), so every result
    is bit-identical to running that spec alone on either engine: the
    batching — and therefore mid-run admission — changes kernel dispatch
    count, never results.  Results come back in ``specs`` order followed
    by ``admissions`` order.  The table work runs on ``device``.  With
    the tracer on, each job's host steps leave ``sim.start_tier`` and
    ``sim.finish_tier`` wall spans (args: job tag, level) and each shared
    dispatch a ``sim.dispatch`` span naming the jobs whose table work it
    ran."""
    entries: list[tuple[int, JobSpec]] = [(0, s) for s in specs]
    for step, s in admissions:
        step = int(step)
        if step < 0:
            raise ValueError(f"admission step {step} must be >= 0")
        entries.append((step, s))
    runs: list[_JobRun | None] = [None] * len(entries)
    results: list[SimResult | None] = [None] * len(entries)
    tracer = obs_trace.get_tracer()
    n_done = 0
    step = 0
    while n_done < len(entries):
        pending = []
        for i, (t0, spec) in enumerate(entries):
            if results[i] is not None or step < t0:
                continue
            ts = time.perf_counter()
            if runs[i] is None:  # this step's arrivals enter the batch
                runs[i] = _JobRun(spec, device)
            r = runs[i]
            pending.append((i, r, step - t0, r.start_tier(step - t0)))
            tracer.add_wall_span("sim.start_tier", ts, time.perf_counter(),
                                 cat="sim.host",
                                 args={"job": r.tag, "level": step - t0})
        works = [w for _, _, _, w in pending if w is not None]
        if works:
            with tracer.span("sim.dispatch", "sim.device", {
                    "jobs": [r.tag for _, r, _, w in pending
                             if w is not None and w.kernel_key is not None]}):
                vsim.dispatch_tier_ingest(works)
        for i, r, l, w in pending:
            ts = time.perf_counter()
            if w is not None:
                r.finish_tier(l, w)
            if l == r.n_levels - 1:  # departure: finalize and free the slot
                results[i] = r.finalize()
                runs[i] = None
                n_done += 1
            tracer.add_wall_span("sim.finish_tier", ts, time.perf_counter(),
                                 cat="sim.host",
                                 args={"job": r.tag, "level": l})
        step += 1
    return list(results)


def drain_calibration(result: SimResult) -> dict[str, float]:
    """Measured-vs-modeled drain factors for ``JobScheduler.calibrate``.

    The planner's drain model charges payload bytes at line rate; the wire
    also carries headers and retransmissions.  The factor per axis is
    ``wire_bytes / payload_bytes`` (>= 1), i.e. how much longer the level
    really takes to drain than the payload-only model claims.
    """
    out = {}
    for axis, s in result.link_stats.items():
        if axis == "reducer":
            continue
        payload = s["payload_bytes"]
        out[axis] = (s["bytes"] / payload) if payload > 0 else 1.0
    return out


def jct_comparison(
    keys,
    values,
    *,
    fanins: Sequence[int],
    plan: dataplane.CascadePlan | None = None,
    op: str = "sum",
    cfg: NetConfig | None = None,
    axes: Sequence[str] | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """The Fig. 10 measurement: JCT with in-network aggregation vs the
    host-only baseline on the same network, same loss pattern, the table
    work on ``device``.

    The returned dict is JSON-able except for ``_results``, the raw
    ``(switchagg, host_only)`` SimResult pair for callers (the JCT bench)
    that need more than the report scalars — drop the key before dumping.
    """
    sw, host = _simulate_jobs([
        JobSpec(keys=keys, values=values, fanins=fanins, plan=plan, op=op,
                aggregate=True, cfg=cfg, axes=axes, tag="switchagg"),
        JobSpec(keys=keys, values=values, fanins=fanins, plan=plan, op=op,
                aggregate=False, cfg=cfg, axes=axes, tag="host_only")],
        device=resolve_device(device))
    return {
        "switchagg": sw.report(),
        "host_only": host.report(),
        "jct_switchagg_s": sw.jct_s,
        "jct_host_only_s": host.jct_s,
        "jct_saved": 1.0 - sw.jct_s / host.jct_s if host.jct_s > 0 else 0.0,
        "reduction": 1.0 - (sw.arrived_records
                            / max(1, host.arrived_records)),
        "_results": (sw, host),
    }

