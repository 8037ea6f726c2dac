"""Plan-driven multi-level aggregation dataplane (DESIGN.md §6), ported to
torch (counterpart of ``repro/core/dataplane.py``).

A ``CascadePlan`` runs as a multi-level cascade —

    level 0 FPE/BPE node  --evictions+flush-->  level 1 node  --> ... root

— each level a bounded-memory SwitchAgg node with per-level telemetry
(records in/out, evictions, reduction ratio).

Two backends execute the same plan: ``torch`` (the counterpart of the JAX
package's ``jnp``: ``core.kvagg.fpe_aggregate``, which on a CUDA tensor
launches the FPE kernel for the exact scan) and ``cuda`` (the counterpart
of ``pallas``: the ``kernels.kv_aggregate`` wrapper with its fast-mode
contract).  Op semantics come from ``core.aggops``; cascades carry the
op's carried representation between levels and finalize at the root.

A ``LevelSpec`` with ``capacity == 0`` is the exact unbounded node (pure
sorted combine, no FPE).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import aggops, kvagg
from . import reduction_model as rm

EMPTY_KEY = kvagg.EMPTY_KEY

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One cascade hop: an FPE/BPE node's geometry.

    capacity == 0 means the exact unbounded combine (no FPE, no evictions);
    ``enabled == False`` is a forward-only hop (DESIGN.md §9) that relays
    every record unaggregated.
    """

    capacity: int
    ways: int = 4
    bpe: bool = True
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """The dataplane's view of a controller plan: op + per-level nodes."""

    op: str
    levels: tuple[LevelSpec, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("a cascade needs at least one level")
        aggops.get(self.op)  # fail fast on unknown ops

    @property
    def capacities(self) -> tuple[int, ...]:
        return tuple(l.capacity for l in self.levels)

    def describe(self) -> str:
        caps = " -> ".join(str(c) for c in self.capacities)
        return f"{self.op} cascade [{caps}]"


def even_split_levels(budget: int, n_levels: int, *, ways: int = 4,
                      bpe: bool = True) -> tuple[LevelSpec, ...]:
    """THE per-level memory partition rule: a tree's combiner budget split
    evenly among its levels (each slice >= 1 pair); budget 0 means every
    level is the exact unbounded node."""
    n_levels = max(1, n_levels)
    cap = max(1, budget // n_levels) if budget > 0 else 0
    return tuple(LevelSpec(capacity=cap, ways=ways, bpe=bpe)
                 for _ in range(n_levels))


def uniform_levels(capacity: int, n_levels: int, *, ways: int = 4,
                   bpe: bool = True) -> tuple[LevelSpec, ...]:
    """Per-NODE sizing: every level gets the full ``capacity``."""
    return tuple(LevelSpec(capacity=max(0, capacity), ways=ways, bpe=bpe)
                 for _ in range(max(1, n_levels)))


def placement_levels(capacities: Sequence[int], enabled: Sequence[bool],
                     *, ways: int = 4, bpe: bool = True
                     ) -> tuple[LevelSpec, ...]:
    """Per-level specs from a fat-tree placement (DESIGN.md §9): each level
    gets its own per-switch capacity, and unplaced levels are forward-only
    hops."""
    capacities = tuple(int(c) for c in capacities)
    enabled = tuple(bool(e) for e in enabled)
    if len(capacities) != len(enabled):
        raise ValueError("level_capacities and level_enabled differ in length")
    if not capacities:
        raise ValueError("a placement needs at least one level")
    return tuple(LevelSpec(capacity=c, ways=ways, bpe=bpe, enabled=e)
                 for c, e in zip(capacities, enabled))


def plan_from_placement(placement, *, op: str = "sum", ways: int = 4,
                        bpe: bool = True) -> CascadePlan:
    """Cascade for a tree placement (duck-typed on ``level_capacities`` /
    ``level_enabled``)."""
    return CascadePlan(op=op, levels=placement_levels(
        placement.level_capacities, placement.level_enabled,
        ways=ways, bpe=bpe))


def plan_from_configure(cfg, *, ways: int = 4, bpe: bool = True) -> CascadePlan:
    """Per-level memory partition of a controller configure message
    (duck-typed: ``level_axes``, ``fpe_capacity``, ``op``, optional
    ``level_capacities``/``level_enabled``; a job plan's ``configure``
    attribute is accepted too)."""
    cfg = getattr(cfg, "configure", cfg)
    caps = tuple(getattr(cfg, "level_capacities", ()) or ())
    if caps:
        enabled = tuple(getattr(cfg, "level_enabled", ()) or
                        (True,) * len(caps))
        return CascadePlan(op=cfg.op, levels=placement_levels(
            caps, enabled, ways=ways, bpe=bpe))
    return CascadePlan(
        op=cfg.op,
        levels=even_split_levels(cfg.fpe_capacity, len(cfg.level_axes),
                                 ways=ways, bpe=bpe),
    )


def cascade_from_exchange_plan(xplan, *, ways: int = 4,
                               bpe: bool = True, op: str | None = None
                               ) -> CascadePlan:
    """Cascade for a gradient exchange plan (duck-typed: ``upper_axes``,
    ``fpe_capacity``, optional ``op``/``level_capacities``/
    ``level_enabled``): one node per upper (scarce) axis hop."""
    op = op if op is not None else getattr(xplan, "op", "sum")
    n = max(1, len(xplan.upper_axes))
    caps = tuple(getattr(xplan, "level_capacities", ()) or ())
    if len(caps) >= n:  # trailing entries = the upper (scarce) hops
        enabled = tuple(getattr(xplan, "level_enabled", ()) or
                        (True,) * len(caps))
        return CascadePlan(op=op, levels=placement_levels(
            caps[-n:], enabled[-n:], ways=ways, bpe=bpe))
    return CascadePlan(
        op=op,
        levels=even_split_levels(xplan.fpe_capacity, len(xplan.upper_axes),
                                 ways=ways, bpe=bpe),
    )


class LevelStats(NamedTuple):
    n_in: torch.Tensor  # [] int32 — real pairs entering the node
    n_out: torch.Tensor  # [] int32 — forwarded pairs leaving the node
    n_evict: torch.Tensor  # [] int32 — FPE evictions at the node


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def run_level(
    keys: torch.Tensor,
    values: torch.Tensor,
    spec: LevelSpec,
    op: str,
    *,
    backend: str = "torch",
    exact_stream: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, LevelStats]:
    """One cascade hop on carried values.

    Returns (out_keys, out_values, stats): [cap + n(+cap)] (table flush +
    eviction stream, BPE-combined when ``spec.bpe``) with ``capacity > 0``;
    the exact packed combine [n] with ``capacity == 0``; the input itself
    for a disabled spec.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown dataplane backend: {backend!r}")
    dev = keys.device
    if not spec.enabled:
        n_real = (keys != EMPTY_KEY).sum().to(torch.int32)
        return keys, values, LevelStats(
            n_in=n_real, n_out=n_real, n_evict=_i32(0, dev))
    if spec.capacity == 0:
        n_in = (keys != EMPTY_KEY).sum().to(torch.int32)
        c = kvagg.sorted_combine(keys, values, op=op)
        return c.unique_keys, c.combined_values, LevelStats(
            n_in=n_in, n_out=c.n_unique, n_evict=_i32(0, dev))
    if backend == "cuda":
        from repro_torch.kernels.kv_aggregate import fpe_aggregate_cuda

        tk, tv, ek, ev = fpe_aggregate_cuda(
            keys, values, capacity=spec.capacity, ways=spec.ways, op=op,
            exact_stream=exact_stream)
    else:
        tk, tv, ek, ev = kvagg.fpe_aggregate(
            keys, values, capacity=spec.capacity, ways=spec.ways, op=op,
            exact_stream=exact_stream)
    res = kvagg.assemble_node(keys, tk, tv, ek, ev, op=op, bpe=spec.bpe)
    return res.out_keys, res.out_values, LevelStats(
        n_in=res.n_in, n_out=res.n_out, n_evict=res.n_evict)


class CascadeResult(NamedTuple):
    """Root output + per-level telemetry of one cascade execution.

    ``n_in``/``n_out`` are the traffic endpoints: pairs entering level 0
    and pairs leaving the last level (BEFORE any final packing).
    """

    keys: torch.Tensor
    values: torch.Tensor
    n_in: torch.Tensor  # [] int32
    n_out: torch.Tensor  # [] int32
    level_in: torch.Tensor  # [n_levels] int32
    level_out: torch.Tensor  # [n_levels] int32
    level_evict: torch.Tensor  # [n_levels] int32


def run_cascade(
    keys: torch.Tensor,
    values: torch.Tensor,
    plan: CascadePlan,
    *,
    backend: str = "torch",
    final_combine: bool = True,
    prepare: bool = True,
    finalize: bool = True,
    exact_stream: bool = True,
) -> CascadeResult:
    """Execute a full multi-level cascade plan over one KV stream, on the
    device the tensors lie on.

    The eviction-plus-flush stream of level *i* feeds level *i+1*.
    ``final_combine`` packs the root stream into unique keys without
    affecting ``n_out``.  ``exact_stream=False`` runs every FPE on the
    batched-block fast path (DESIGN.md §8).
    """
    op = aggops.get(plan.op)
    k = keys
    v = op.prepare_values(values) if prepare else values
    li, lo, le = [], [], []
    for spec in plan.levels:
        k, v, stats = run_level(k, v, spec, plan.op, backend=backend,
                                exact_stream=exact_stream)
        li.append(stats.n_in)
        lo.append(stats.n_out)
        le.append(stats.n_evict)
    n_out = lo[-1]
    if final_combine:
        c = kvagg.sorted_combine(k, v, op=plan.op)
        k, v = c.unique_keys, c.combined_values
    if finalize:
        v = op.finalize_values(v)
    return CascadeResult(
        keys=k, values=v, n_in=li[0], n_out=n_out,
        level_in=torch.stack(li), level_out=torch.stack(lo),
        level_evict=torch.stack(le),
    )


# ---------------------------------------------------------------------------
# Streaming (packet-batched) ingest — DESIGN.md §7.
# ---------------------------------------------------------------------------


class LevelState:
    """One cascade node ingesting packet-sized batches (DESIGN.md §7).

    The stateful counterpart of :func:`run_level`: the FPE table persists
    *across* ``ingest`` calls, on ``device`` — on a card every ingest
    resumes the FPE kernel from the stored table.  Ingests are padded to
    ``batch_pad`` (chunked past it) or, without it, to the next power of
    two (min ``MIN_PAD``), as in the JAX package.  A ``capacity == 0``
    spec is the exact unbounded node: ingests buffer rows, compacted by a
    pow2-padded ``sorted_combine`` whenever the buffer tops
    ``COMPACT_THRESHOLD`` and at flush.  A disabled spec relays every
    real record verbatim and flushes nothing.

    Telemetry: ``n_in`` real pairs ingested, ``n_evict`` FPE evictions,
    ``n_out`` pairs forwarded downstream.
    """

    COMPACT_THRESHOLD = 8192
    MIN_PAD = 8

    def __init__(self, spec: LevelSpec, op: str, *,
                 batch_pad: int | None = None, exact_stream: bool = True,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.op = op
        self._aggop = aggops.get(op)
        self.batch_pad = batch_pad
        self.exact_stream = exact_stream
        self.device = resolve_device(device)
        self._tk: torch.Tensor | None = None
        self._tv: torch.Tensor | None = None
        self._exact: list[tuple[torch.Tensor, torch.Tensor]] | None = (
            [] if spec.capacity == 0 and spec.enabled else None)
        self._exact_rows = 0
        self._value_sample: torch.Tensor | None = None  # dtype/lane template
        self.n_in = 0
        self._n_evict: torch.Tensor | int = 0  # on the device until read
        self.n_out = 0
        self._flushed = False

    @property
    def n_evict(self) -> int:
        """FPE evictions so far.  Counted on the device per ingest and read
        back only here, so an ingest waits on one fewer synchronisation."""
        return int(self._n_evict)

    @n_evict.setter
    def n_evict(self, value: int) -> None:
        self._n_evict = value

    def _empty_out(self) -> tuple[torch.Tensor, torch.Tensor]:
        k = torch.zeros((0,), dtype=torch.int32, device=self.device)
        if self._value_sample is None:
            return k, torch.zeros((0,), dtype=torch.float32,
                                  device=self.device)
        v = self._value_sample
        return k, torch.zeros((0,) + tuple(v.shape), dtype=v.dtype,
                              device=self.device)

    def ingest(self, keys, values) -> tuple[torch.Tensor, torch.Tensor]:
        """Feed one batch of carried-representation records (numpy or
        tensors); returns the packed (keys, values) this node forwards
        downstream right now, on the node's device."""
        if self._flushed:
            raise RuntimeError("LevelState already flushed")
        keys = as_tensor(keys, self.device).to(torch.int32)
        values = as_tensor(values, self.device)
        if keys.shape[0] != values.shape[0]:
            raise ValueError("keys/values leading dims differ")
        if self._value_sample is None and values.shape[0]:
            self._value_sample = torch.zeros(
                tuple(values.shape[1:]), dtype=values.dtype,
                device=self.device)
        real = keys != EMPTY_KEY
        n_real = int(real.sum())
        self.n_in += n_real
        if not n_real:
            return self._empty_out()
        if not self.spec.enabled:  # forward-only hop (DESIGN.md §9)
            fk, fv = keys[real], values[real]
            self.n_out += int(fk.shape[0])
            return fk, fv
        if self._exact is not None:  # capacity == 0: exact unbounded node
            self._exact.append((keys[real], values[real]))
            self._exact_rows += n_real
            if self._exact_rows > self.COMPACT_THRESHOLD:
                self._compact_exact()
            return self._empty_out()
        if self.batch_pad:
            pad = self.batch_pad
        else:
            pad = max(self.MIN_PAD,
                      1 << (int(keys.shape[0]) - 1).bit_length())
        out_k, out_v = [], []
        for lo in range(0, keys.shape[0], pad):
            ek, ev = self._ingest_chunk(keys[lo:lo + pad],
                                        values[lo:lo + pad], pad)
            if ek.numel():
                out_k.append(ek)
                out_v.append(ev)
        if not out_k:
            return self._empty_out()
        fk, fv = torch.cat(out_k), torch.cat(out_v)
        self.n_out += fk.shape[0]
        return fk, fv

    def _ingest_chunk(self, keys: torch.Tensor, values: torch.Tensor,
                      pad: int) -> tuple[torch.Tensor, torch.Tensor]:
        if keys.shape[0] < pad:
            fill = pad - keys.shape[0]
            keys = torch.cat([keys, torch.full((fill,), EMPTY_KEY,
                                               dtype=torch.int32,
                                               device=self.device)])
            values = torch.cat([values, torch.zeros(
                (fill,) + tuple(values.shape[1:]), dtype=values.dtype,
                device=self.device)])
        res = kvagg.fpe_aggregate(
            keys, values, capacity=self.spec.capacity, ways=self.spec.ways,
            op=self.op, exact_stream=self.exact_stream,
            table_keys=self._tk, table_values=self._tv)
        self._tk, self._tv = res.table_keys, res.table_values
        ek, ev = res.evict_keys, res.evict_values
        mask = ek != EMPTY_KEY
        self._n_evict = self._n_evict + mask.sum()
        if self.spec.bpe:  # combine this packet's evictions (fixed shape)
            c = kvagg.sorted_combine(ek, ev, op=self.op)
            nu = int(c.n_unique)  # the unique keys are packed in front
            return c.unique_keys[:nu], c.combined_values[:nu]
        keep = mask.nonzero().squeeze(1)
        return ek.index_select(0, keep), ev.index_select(0, keep)

    def _compact_exact(self) -> None:
        """Collapse the capacity-0 buffer to its unique-key combine (one
        pow2-padded bulk ``sorted_combine``)."""
        k = torch.cat([k for k, _ in self._exact])
        v = torch.cat([v for _, v in self._exact])
        pad = max(1, 1 << (int(k.shape[0]) - 1).bit_length()) - k.shape[0]
        if pad:
            k = torch.cat([k, torch.full((pad,), EMPTY_KEY, dtype=torch.int32,
                                         device=self.device)])
            v = torch.cat([v, torch.zeros((pad,) + tuple(v.shape[1:]),
                                          dtype=v.dtype, device=self.device)])
        c = kvagg.sorted_combine(k, v, op=self.op)
        nu = int(c.n_unique)
        self._exact = [(c.unique_keys[:nu], c.combined_values[:nu])]
        self._exact_rows = nu

    def flush(self) -> tuple[torch.Tensor, torch.Tensor]:
        """End-of-task flush: pack and emit every resident pair."""
        self._flushed = True
        if self._exact is not None:
            if not self._exact_rows:
                return self._empty_out()
            self._compact_exact()
            fk, fv = self._exact[0]
        elif self._tk is None:
            return self._empty_out()
        else:
            mask = self._tk != EMPTY_KEY
            fk, fv = self._tk[mask], self._tv[mask]
        self.n_out += fk.shape[0]
        return fk, fv


def run_cascade_stream(
    batches: Iterable[tuple],
    plan: CascadePlan,
    *,
    batch_pad: int | None = None,
    final_combine: bool = True,
    prepare: bool = True,
    finalize: bool = True,
    exact_stream: bool = True,
    device: str | torch.device = "cuda",
) -> CascadeResult:
    """Packet-batched counterpart of :func:`run_cascade` (DESIGN.md §7).

    ``batches`` yields (keys, values) ingests, numpy or tensors; they are
    moved to ``device``.  Per-level node state persists across batches and
    each batch's evictions cascade downstream immediately; the end of the
    stream flushes the tables leaf to root.  Grouping the root stream by
    key equals :func:`run_cascade`'s result for every op.
    """
    dev = resolve_device(device)
    op = aggops.get(plan.op)
    states = [LevelState(spec, plan.op, batch_pad=batch_pad,
                         exact_stream=exact_stream, device=dev)
              for spec in plan.levels]
    root_k: list[torch.Tensor] = []
    root_v: list[torch.Tensor] = []

    def push(i: int, k, v) -> None:
        if k.shape[0] == 0:
            return
        if i == len(states):
            root_k.append(k)
            root_v.append(v)
            return
        ek, ev = states[i].ingest(k, v)
        push(i + 1, ek, ev)

    with obs_trace.get_tracer().span("dataplane.run_cascade_stream",
                                     cat="dataplane"):
        for k, v in batches:
            k = as_tensor(k, dev).to(torch.int32)
            v = as_tensor(v, dev)
            push(0, k, op.prepare_values(v) if prepare else v)
        for i, st in enumerate(states):
            fk, fv = st.flush()
            push(i + 1, fk, fv)

    if root_k:
        rk = torch.cat(root_k)
        rv = torch.cat(root_v)
    else:
        rk = torch.zeros((0,), dtype=torch.int32, device=dev)
        # an empty root still needs the op's carried lane shape
        tmpl = states[0]._value_sample
        if tmpl is not None:
            rv = torch.zeros((0,) + tuple(tmpl.shape), dtype=tmpl.dtype,
                             device=dev)
        elif prepare:
            rv = op.prepare_values(torch.zeros((0,), dtype=torch.float32,
                                               device=dev))
        else:
            rv = torch.zeros((0,), dtype=torch.float32, device=dev)
    k_out, v_out = rk, rv
    if final_combine and rk.numel():
        c = kvagg.sorted_combine(k_out, v_out, op=plan.op)
        k_out, v_out = c.unique_keys, c.combined_values
    if finalize:
        v_out = op.finalize_values(v_out)
    _publish_levels(
        plan.op,
        [{"level": i, "records_in": int(s.n_in),
          "records_out": int(s.n_out), "evictions": int(s.n_evict),
          "reduction": round(1.0 - int(s.n_out) / max(int(s.n_in), 1), 4)}
         for i, s in enumerate(states)],
        end_to_end=round(1.0 - int(states[-1].n_out)
                         / max(int(states[0].n_in), 1), 4),
        source="stream")
    return CascadeResult(
        keys=k_out, values=v_out,
        n_in=_i32(states[0].n_in, dev), n_out=_i32(states[-1].n_out, dev),
        level_in=_i32([s.n_in for s in states], dev),
        level_out=_i32([s.n_out for s in states], dev),
        level_evict=_i32([s.n_evict for s in states], dev),
    )


def level_reductions(res: CascadeResult) -> torch.Tensor:
    """Per-hop measured reduction ratio R_i = 1 - out_i/in_i (paper's R)."""
    return 1.0 - res.level_out / res.level_in.clamp(min=1)


def end_to_end_reduction(res: CascadeResult) -> torch.Tensor:
    """Whole-cascade reduction: traffic leaving the root vs entering leaf."""
    return 1.0 - res.n_out / res.n_in.clamp(min=1)


def predicted_level_reductions(
    plan: CascadePlan, data_amount: int, key_variety: int
) -> list[float]:
    """Eq. 3 applied hop by hop: level *i* sees the (modeled) survivor
    stream of level *i-1*; key variety is preserved by aggregation."""
    preds = []
    m = float(max(1, data_amount))
    n = float(max(1, min(key_variety, data_amount)))
    for spec in plan.levels:
        if spec.capacity == 0:  # exact node: ideal reduction
            r = 1.0 - min(n, m) / m
        else:
            r = rm.reduction_ratio(m, min(n, m), spec.capacity)
        preds.append(r)
        m = max(n, m * (1.0 - r))
    return preds


def _publish_levels(op_name: str, levels: list, *, end_to_end: float,
                    source: str) -> None:
    """Per-level cascade telemetry into the obs registry (DESIGN.md §11):
    the same ``dataplane.level.*`` series and labels as the JAX package."""
    reg = obs_metrics.get_registry()
    base = {"op": op_name, "source": source}
    for lvl in levels:
        lbl = dict(base, level=lvl["level"])
        reg.counter("dataplane.level.records_in_total",
                    **lbl).inc(lvl["records_in"])
        reg.counter("dataplane.level.records_out_total",
                    **lbl).inc(lvl["records_out"])
        reg.counter("dataplane.level.evictions_total",
                    **lbl).inc(lvl["evictions"])
        reg.gauge("dataplane.level.reduction", **lbl).set(lvl["reduction"])
        if "predicted_reduction" in lvl:
            reg.gauge("dataplane.level.predicted_reduction",
                      **lbl).set(lvl["predicted_reduction"])
    reg.gauge("dataplane.end_to_end_reduction", **base).set(end_to_end)


def telemetry(res: CascadeResult, plan: CascadePlan) -> dict:
    """JSON-able per-level report (the dry-run / bench record)."""
    li = [int(x) for x in res.level_in.tolist()]
    lo = [int(x) for x in res.level_out.tolist()]
    le = [int(x) for x in res.level_evict.tolist()]
    levels = []
    for i, spec in enumerate(plan.levels):
        levels.append({
            "level": i,
            "capacity": spec.capacity,
            "records_in": li[i],
            "records_out": lo[i],
            "evictions": le[i],
            "reduction": round(1.0 - lo[i] / max(li[i], 1), 4),
        })
    report = {
        "op": plan.op,
        "levels": levels,
        "n_in": int(res.n_in),
        "n_out": int(res.n_out),
        "end_to_end_reduction": round(float(end_to_end_reduction(res)), 4),
    }
    _publish_levels(plan.op, levels,
                    end_to_end=report["end_to_end_reduction"],
                    source="cascade")
    return report


def simulate_plan(
    plan: CascadePlan,
    *,
    data_amount: int = 4096,
    key_variety: int = 512,
    dist: str = "uniform",
    seed: int = 0,
    backend: str = "torch",
    device: str | torch.device = "cuda",
) -> dict:
    """Run a synthetic stream (made from ``seed`` with numpy) through the
    cascade on ``device`` and report per-level predicted (Eq. 3) vs
    simulated reduction."""
    dev = resolve_device(device)
    gen = rm.uniform_keys if dist == "uniform" else rm.zipf_keys
    keys = torch.from_numpy(
        gen(data_amount, key_variety, seed=seed).astype(np.int32)).to(dev)
    values = torch.ones((data_amount,), dtype=torch.float32, device=dev)
    res = run_cascade(keys, values, plan, backend=backend)
    report = telemetry(res, plan)
    preds = predicted_level_reductions(plan, data_amount, key_variety)
    reg = obs_metrics.get_registry()
    for lvl, p in zip(report["levels"], preds):
        lvl["predicted_reduction"] = round(p, 4)
        reg.gauge("dataplane.level.predicted_reduction", op=plan.op,
                  source="cascade",
                  level=lvl["level"]).set(lvl["predicted_reduction"])
    report["dist"] = dist
    report["data_amount"] = data_amount
    report["key_variety"] = key_variety
    return report
