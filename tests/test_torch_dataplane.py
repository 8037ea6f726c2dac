"""repro_torch.core.dataplane against repro.core.dataplane (CPU).

Tolerances: keys, level counters and traffic are exact; values too where
both sides run the scan (every FPE combines in stream order, and the BPE
and root combines add in index order on the CPU on both sides).
logsumexp: rtol 1e-6, atol 1e-6 (exp/log/log1p differ in the last ulp).
The fast path (``exact_stream=False``) and the packet stream group the
same addends in other orders than a single scan would, so their
roots are compared with ``run_cascade``'s at rtol 1e-5, atol 1e-5.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import aggops as jaggops
from repro.core import dataplane as jdp
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import convert
from repro_torch.core import dataplane as dp
from repro_torch.core.dataplane import CascadePlan, LevelSpec
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

EMPTY = -1
OPS = ("count", "logsumexp", "max", "mean", "min", "sum")


def _t(x):
    return convert.tensor(x, device="cpu")


def _stream(seed, n=400, variety=96):
    r = np.random.default_rng(seed)
    keys = r.integers(0, variety, n).astype(np.int32)
    keys[r.random(n) < 0.05] = EMPTY
    return keys, (r.standard_normal(n) * 3).astype(np.float32)


def _plans(levels, op):
    """The same plan in both packages."""
    jplan = jdp.CascadePlan(op=op, levels=tuple(
        jdp.LevelSpec(capacity=l.capacity, ways=l.ways, bpe=l.bpe,
                      enabled=l.enabled) for l in levels))
    return jplan, convert.cascade_plan(jplan)


def _assert_values(want, got, op, rtol=0.0, atol=0.0):
    want = np.asarray(want)
    got = got.numpy()
    if op == "logsumexp":
        rtol, atol = max(rtol, 1e-6), max(atol, 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _assert_cascade_same(jr, tr, op, rtol=0.0, atol=0.0):
    for name in ("keys", "n_in", "n_out", "level_in", "level_out",
                 "level_evict"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    _assert_values(jr.values, tr.values, op, rtol, atol)


#: every op, the plans rotated so that each plan meets two ops.  Each
#: (op, plan) compiles the JAX cascade once; the seeds reuse that compile.
CASCADE_CASES = [(op, ((64, 1, 4), (1,), (4, 16))[i % 3])
                 for i, op in enumerate(OPS)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op,caps", CASCADE_CASES)
def test_run_cascade_matches_jax(op, caps, seed):
    keys, vals = _stream(sum(caps) + 100 * seed)
    jplan, plan = _plans([LevelSpec(capacity=c) for c in caps], op)
    jr = jdp.run_cascade(jnp.asarray(keys), jnp.asarray(vals), jplan)
    tr = dp.run_cascade(_t(keys), _t(vals), plan)
    _assert_cascade_same(jr, tr, op)


@pytest.mark.parametrize("op,seed", [("mean", 21), ("mean", 22)])
def test_cuda_backend_matches_jnp_backend(op, seed):
    """backend="cuda" (the "pallas" counterpart) on CPU tensors: the
    kernel wrapper's plain scan, same result as the jnp backend."""
    keys, vals = _stream(seed)
    jplan, plan = _plans([LevelSpec(capacity=8), LevelSpec(capacity=32)], op)
    jr = jdp.run_cascade(jnp.asarray(keys), jnp.asarray(vals), jplan)
    tr = dp.run_cascade(_t(keys), _t(vals), plan, backend="cuda")
    _assert_cascade_same(jr, tr, op)


@pytest.mark.parametrize("op,seed", [("logsumexp", 22), ("logsumexp", 23)])
def test_fast_path_cascade_matches_jax(op, seed):
    keys, vals = _stream(seed)
    jplan, plan = _plans([LevelSpec(capacity=16), LevelSpec(capacity=8)], op)
    jr = jdp.run_cascade(jnp.asarray(keys), jnp.asarray(vals), jplan,
                         exact_stream=False)
    tr = dp.run_cascade(_t(keys), _t(vals), plan, exact_stream=False)
    _assert_cascade_same(jr, tr, op)


def test_capacity_zero_and_disabled_levels_match_jax():
    keys, vals = _stream(23)
    levels = [LevelSpec(capacity=8), LevelSpec(capacity=0, enabled=False),
              LevelSpec(capacity=0), LevelSpec(capacity=4, bpe=False)]
    jplan, plan = _plans(levels, "sum")
    jr = jdp.run_cascade(jnp.asarray(keys), jnp.asarray(vals), jplan,
                         final_combine=False)
    tr = dp.run_cascade(_t(keys), _t(vals), plan, final_combine=False)
    _assert_cascade_same(jr, tr, "sum")
    assert tr.level_evict.tolist()[1:3] == [0, 0]


def test_unknown_backend_raises():
    keys, vals = _stream(1, n=16)
    plan = CascadePlan(op="sum", levels=(LevelSpec(capacity=4),))
    with pytest.raises(ValueError, match="backend"):
        dp.run_cascade(_t(keys), _t(vals), plan, backend="pallas")
    with pytest.raises(ValueError, match="at least one level"):
        CascadePlan(op="sum", levels=())
    with pytest.raises(ValueError, match="unsupported aggregation op"):
        CascadePlan(op="median", levels=(LevelSpec(capacity=4),))


def _packets(keys, vals, sizes):
    out, i, j = [], 0, 0
    while i < keys.shape[0]:
        m = sizes[j % len(sizes)]
        out.append((keys[i:i + m], vals[i:i + m]))
        i, j = i + m, j + 1
    return out


@pytest.mark.parametrize("op,batch_pad,seed", [("sum", None, 31),
                                               ("sum", None, 32),
                                               ("mean", 16, 31)])
def test_run_cascade_stream_matches_jax(op, batch_pad, seed):
    keys, vals = _stream(seed, n=300)
    pk = _packets(keys, vals, [7, 29, 3, 59] if batch_pad is None else [7, 29])
    levels = [LevelSpec(capacity=16), LevelSpec(capacity=0),
              LevelSpec(capacity=8, ways=2)]
    jplan, plan = _plans(levels, op)
    jr = jdp.run_cascade_stream(iter(pk), jplan, batch_pad=batch_pad)
    tr = dp.run_cascade_stream(iter(pk), plan, batch_pad=batch_pad,
                               device="cpu")
    _assert_cascade_same(jr, tr, op)
    # grouping the streamed root equals the monolithic cascade's root
    mono = dp.run_cascade(_t(keys), _t(vals), plan)
    real = tr.keys != EMPTY
    np.testing.assert_array_equal(tr.keys[real].numpy(),
                                  mono.keys[mono.keys != EMPTY].numpy())
    np.testing.assert_allclose(tr.values[real].numpy(),
                               mono.values[mono.keys != EMPTY].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_stream_fast_path_and_compaction_match_jax(monkeypatch):
    """exact_stream=False ingest, and the capacity-0 node compacting its
    buffer many times (a small COMPACT_THRESHOLD on both sides)."""
    monkeypatch.setattr(jdp.LevelState, "COMPACT_THRESHOLD", 40)
    monkeypatch.setattr(dp.LevelState, "COMPACT_THRESHOLD", 40)
    keys, vals = _stream(32, n=300)
    pk = _packets(keys, vals, [13, 31])
    jplan, plan = _plans([LevelSpec(capacity=0), LevelSpec(capacity=8)],
                         "sum")
    jr = jdp.run_cascade_stream(iter(pk), jplan, exact_stream=False)
    tr = dp.run_cascade_stream(iter(pk), plan, exact_stream=False,
                               device="cpu")
    _assert_cascade_same(jr, tr, "sum")


def test_stream_empty_and_all_padding():
    plan = CascadePlan(op="mean", levels=(LevelSpec(capacity=4),))
    jplan = jdp.CascadePlan(op="mean", levels=(jdp.LevelSpec(capacity=4),))
    pads = [(np.full(5, EMPTY, np.int32), np.zeros(5, np.float32))]
    for batches in ([], pads):
        jr = jdp.run_cascade_stream(iter(batches), jplan)
        tr = dp.run_cascade_stream(iter(batches), plan, device="cpu")
        assert tuple(tr.values.shape) == tuple(jr.values.shape)
        assert int(tr.n_in) == int(jr.n_in) == 0


@pytest.mark.parametrize("spec", [LevelSpec(capacity=8, ways=2),
                                  LevelSpec(capacity=8, bpe=False),
                                  LevelSpec(capacity=0),
                                  LevelSpec(capacity=8, enabled=False)])
def test_level_state_packets_match_jax(spec):
    """Ingest by ingest: forwarded pairs, counters and the flush."""
    keys, vals = _stream(33, n=200, variety=40)
    js = jdp.LevelState(jdp.LevelSpec(capacity=spec.capacity, ways=spec.ways,
                                      bpe=spec.bpe, enabled=spec.enabled),
                        "sum")
    ts = dp.LevelState(spec, "sum", device="cpu")
    for k, v in _packets(keys, vals, [9, 33, 1, 17]) + [(keys[:0], vals[:0])]:
        jk, jv = js.ingest(k, v)
        tk, tv = ts.ingest(k, v)
        np.testing.assert_array_equal(tk.numpy(), jk)
        np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ts.flush()[0].numpy(), js.flush()[0])
    assert (ts.n_in, ts.n_out, ts.n_evict) == (js.n_in, js.n_out, js.n_evict)
    with pytest.raises(RuntimeError, match="flushed"):
        ts.ingest(keys[:2], vals[:2])


def test_telemetry_and_metrics_match_jax():
    keys, vals = _stream(41)
    jplan, plan = _plans([LevelSpec(capacity=8), LevelSpec(capacity=32)],
                         "mean")
    with jmetrics.scoped() as jreg, tmetrics.scoped() as treg:
        jrep = jdp.telemetry(jdp.run_cascade(jnp.asarray(keys),
                                             jnp.asarray(vals), jplan), jplan)
        trep = dp.telemetry(dp.run_cascade(_t(keys), _t(vals), plan), plan)
        pk = _packets(keys, vals, [59])
        jdp.run_cascade_stream(iter(pk), jplan)
        dp.run_cascade_stream(iter(pk), plan, device="cpu")
    assert trep == jrep
    assert treg.collect() == jreg.collect()
    names = {m["name"] for m in treg.collect()}
    assert {"dataplane.level.records_in_total", "dataplane.level.reduction",
            "dataplane.end_to_end_reduction"} <= names
    assert float(dp.end_to_end_reduction(dp.run_cascade(
        _t(keys), _t(vals), plan))) == pytest.approx(
            trep["end_to_end_reduction"], abs=1e-4)


def test_stream_span_is_traced():
    keys, vals = _stream(42, n=40)
    plan = CascadePlan(op="sum", levels=(LevelSpec(capacity=4),))
    jplan = jdp.CascadePlan(op="sum", levels=(jdp.LevelSpec(capacity=4),))
    with jtrace.scoped_tracer() as jt, ttrace.scoped_tracer() as tt:
        jdp.run_cascade_stream(iter([(keys, vals)]), jplan)
        dp.run_cascade_stream(iter([(keys, vals)]), plan, device="cpu")
    assert [(e["name"], e["cat"]) for e in tt.events] == \
        [(e["name"], e["cat"]) for e in jt.events] == \
        [("dataplane.run_cascade_stream", "dataplane")]


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_simulate_plan_matches_jax(dist):
    jplan, plan = _plans([LevelSpec(capacity=64), LevelSpec(capacity=16)],
                         "sum")
    with jmetrics.scoped() as jreg, tmetrics.scoped() as treg:
        jrep = jdp.simulate_plan(jplan, data_amount=1024, key_variety=256,
                                 dist=dist, seed=3)
        trep = dp.simulate_plan(plan, data_amount=1024, key_variety=256,
                                dist=dist, seed=3, device="cpu")
    assert trep == jrep
    assert treg.collect() == jreg.collect()


def test_predicted_reductions_and_level_builders_match_jax():
    jplan, plan = _plans([LevelSpec(capacity=c) for c in (0, 16, 256)], "sum")
    for m, n in ((4096, 512), (100, 1000), (1, 1)):
        assert dp.predicted_level_reductions(plan, m, n) == \
            jdp.predicted_level_reductions(jplan, m, n)
    for budget, n_levels in ((0, 2), (100, 3), (2, 5)):
        assert convert.cascade_plan(jdp.CascadePlan(
            "sum", jdp.even_split_levels(budget, n_levels, ways=2))) == \
            CascadePlan("sum", dp.even_split_levels(budget, n_levels, ways=2))
        assert convert.cascade_plan(jdp.CascadePlan(
            "sum", jdp.uniform_levels(budget, n_levels, bpe=False))) == \
            CascadePlan("sum", dp.uniform_levels(budget, n_levels, bpe=False))
    caps, enabled = (64, 0, 16), (True, False, True)
    assert convert.cascade_plan(jdp.CascadePlan(
        "max", jdp.placement_levels(caps, enabled))) == \
        CascadePlan("max", dp.placement_levels(caps, enabled))
    with pytest.raises(ValueError, match="differ in length"):
        dp.placement_levels((1, 2), (True,))
    assert plan.describe() == jplan.describe()
    assert plan.capacities == jplan.capacities


@pytest.mark.parametrize("cfg", [
    dict(level_axes=("data", "pod"), fpe_capacity=1024, op="mean"),
    dict(level_axes=("data",), fpe_capacity=0, op="sum"),
    dict(level_axes=("data", "pod"), fpe_capacity=8, op="max",
         level_capacities=(32, 64), level_enabled=(False, True)),
])
def test_plan_builders_duck_type_like_jax(cfg):
    msg = types.SimpleNamespace(**cfg)
    job = types.SimpleNamespace(configure=msg)
    want = convert.cascade_plan(jdp.plan_from_configure(msg, ways=2))
    assert dp.plan_from_configure(msg, ways=2) == want
    assert dp.plan_from_configure(job, ways=2) == want
    xplan = types.SimpleNamespace(upper_axes=cfg["level_axes"], **{
        k: v for k, v in cfg.items() if k != "level_axes"})
    assert dp.cascade_from_exchange_plan(xplan) == convert.cascade_plan(
        jdp.cascade_from_exchange_plan(xplan))
    placement = types.SimpleNamespace(level_capacities=(8, 0),
                                      level_enabled=(True, False))
    assert dp.plan_from_placement(placement, op="min") == \
        convert.cascade_plan(jdp.plan_from_placement(placement, op="min"))


def test_aggops_names_cover_the_cascade_ops():
    assert tuple(sorted(OPS)) == jaggops.names()
