"""Unified sim report schema + telemetry publishing (DESIGN.md §11).

A copy of the job-report part of ``repro/net/schema.py``, publishing into
the port's ``obs.metrics`` registry: both engines of ``net.sim`` build
their per-level records with :func:`level_report`, their job report with
:func:`report_dict` (``SimResult.report()``), and publish it with
:func:`publish_report`, so node and vectorized runs emit the same metric
series.  The fault and controller report publishers come with the
port's fault plane and controller.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.obs import metrics as obs_metrics

#: every key a job report carries (``SimResult.report()`` output)
REPORT_KEYS = (
    "aggregate", "op", "fanins", "jct_s",
    "delivered_records", "delivered_bytes", "arrived_records",
    "retransmissions", "timeouts", "packets_dropped",
    "gap_discards", "duplicate_discards", "mapper_finish_max_s",
    "link_bytes", "link_drain_s", "per_level",
)

#: every key a per-level record carries
LEVEL_KEYS = (
    "level", "axis", "switches", "records_in", "records_out",
    "evictions", "bytes_out", "agg_proc_s", "queue_peak",
)


def level_report(level: int, axis: str, nodes: Sequence) -> dict:
    """One tier's record from its switch nodes (either engine's)."""
    return {
        "level": level,
        "axis": axis,
        "switches": len(nodes),
        "records_in": sum(n.records_in for n in nodes),
        "records_out": sum(n.records_out for n in nodes),
        "evictions": sum(n.state.n_evict if n.state is not None else 0
                         for n in nodes),
        # disabled (forward-only) hops do no aggregation-engine work but
        # still move every byte: zero agg_proc_s, nonzero bytes_out —
        # and the queue depth is tracked for relays too
        "bytes_out": sum(n.bytes_out for n in nodes),
        "agg_proc_s": sum(n.agg_proc_s for n in nodes),
        "queue_peak": max((n.queue_peak for n in nodes), default=0),
    }


def report_dict(result) -> dict:
    """The canonical JSON-able job report from a ``SimResult``."""
    return {
        "aggregate": result.aggregate,
        "op": result.op,
        "fanins": list(result.fanins),
        "jct_s": result.jct_s,
        "delivered_records": result.delivered_records,
        "delivered_bytes": result.delivered_bytes,
        "arrived_records": result.arrived_records,
        "retransmissions": result.retransmissions,
        "timeouts": result.timeouts,
        "packets_dropped": result.packets_dropped,
        "gap_discards": result.gap_discards,
        "duplicate_discards": result.duplicate_discards,
        "mapper_finish_max_s": (max(result.mapper_finish_s)
                                if result.mapper_finish_s else 0.0),
        "link_bytes": {ax: s["bytes"]
                       for ax, s in result.link_stats.items()},
        "link_drain_s": {ax: s["drain_s"]
                         for ax, s in result.link_stats.items()},
        "per_level": result.per_level,
    }


def publish_report(report: dict, *, job: str, engine: str,
                   registry: Optional[object] = None) -> None:
    """Push one job report into the metrics registry as labeled series.

    Label taxonomy (DESIGN.md §11): ``job`` is the caller-chosen tag
    (placement policy, jct-comparison leg, ...), ``engine`` the sim
    engine that produced it, ``agg`` whether in-network aggregation was
    on, plus ``level``/``axis`` on per-tier series.
    """
    reg = registry if registry is not None else obs_metrics.get_registry()
    base = {"job": job, "engine": engine,
            "agg": "1" if report["aggregate"] else "0"}
    op = report["op"]

    g = reg.gauge
    c = reg.counter
    g("sim.job.jct_s", op=op, **base).set(report["jct_s"])
    g("sim.job.mapper_finish_max_s", **base).set(
        report["mapper_finish_max_s"])
    c("sim.job.delivered_records_total", **base).inc(
        report["delivered_records"])
    c("sim.job.delivered_bytes_total", **base).inc(
        report["delivered_bytes"])
    c("sim.job.arrived_records_total", **base).inc(
        report["arrived_records"])
    c("transport.retransmissions_total", **base).inc(
        report["retransmissions"])
    c("transport.timeouts_total", **base).inc(report["timeouts"])
    c("transport.packets_dropped_total", **base).inc(
        report["packets_dropped"])
    c("transport.gap_discards_total", **base).inc(report["gap_discards"])
    c("transport.duplicate_discards_total", **base).inc(
        report["duplicate_discards"])

    for lv in report["per_level"]:
        lbl = dict(base, level=lv["level"], axis=lv["axis"])
        g("sim.level.switches", **lbl).set(lv["switches"])
        c("sim.level.records_in_total", **lbl).inc(lv["records_in"])
        c("sim.level.records_out_total", **lbl).inc(lv["records_out"])
        c("sim.level.evictions_total", **lbl).inc(lv["evictions"])
        c("sim.level.bytes_out_total", **lbl).inc(lv["bytes_out"])
        g("sim.level.agg_proc_s", **lbl).set(lv["agg_proc_s"])
        g("sim.level.queue_peak", **lbl).set(lv["queue_peak"])

    for ax, b in report["link_bytes"].items():
        c("sim.link.wire_bytes_total", axis=ax, **base).inc(b)
    for ax, d in report["link_drain_s"].items():
        g("sim.link.drain_s", axis=ax, **base).set(d)
