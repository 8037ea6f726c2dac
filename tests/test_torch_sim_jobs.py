"""The port's packet simulator on the CPU, continued from
``tests/test_torch_sim.py`` (whose helpers and tolerances this file
uses): disabled hops and the host-only baseline against the JAX package,
``tests/test_net_sim.py``'s word count (the JCT cut of at least 40%),
delivery and loss checks, mapper delays, lockstep batches of jobs with
their ``tier_ingest`` call count, the traced spans of a run, and what
the facade refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import dict_aggregate
from repro.core import reduction_model as jrm
from repro.net import sim as jsim
from repro.net import simulate as jsimulate
from repro_torch.core import aggops, dataplane, kvagg
from repro_torch.net import facade, sim, simulate, vsim
from repro_torch.obs import trace as obs_trace
from test_torch_sim import (OPS, _assert_identical, _assert_three, _plans,
                            _runs, _zipf)


@pytest.mark.parametrize("enabled", [
    [True, True], [False, True], [True, False], [False, False]])
@pytest.mark.parametrize("loss", [0.0, 0.02])
def test_disabled_hops_and_host_only_match_jax(enabled, loss):
    keys = _zipf(500, 48, 5)
    vals = np.ones_like(keys, np.float32)
    cfg = dict(records_per_packet=16, loss_rate=loss, seed=11, window=8)
    _assert_three(_runs(keys, vals, caps=[32, 16], enabled=enabled, **cfg),
                  "sum")
    _assert_three(_runs(keys, vals, caps=[32, 16], aggregate=False, **cfg),
                  "sum")


def test_wordcount_jct_reduction_at_least_40pct():
    """The paper's 8-mapper Zipf word count (Fig. 10), as
    ``tests/test_net_sim.py`` runs it: the port cuts the JCT by >= 40%,
    with the JAX package's numbers exactly, on both engines."""
    keys = jrm.zipf_keys(8 * 1024, 1024, skew=0.99, seed=0)
    vals = np.ones_like(keys, dtype=np.float32)
    jplan, plan = _plans([512, 512])
    want = jsim.jct_comparison(
        keys, vals, fanins=(4, 2), plan=jplan, cfg=jsim.NetConfig(
            link_gbps=(jsim.TEN_GBE,) * 2, reducer_gbps=jsim.TEN_GBE))
    for eng in ("node", "vectorized"):
        got = sim.jct_comparison(
            keys, vals, fanins=(4, 2), plan=plan, device="cpu",
            cfg=sim.NetConfig(link_gbps=(sim.TEN_GBE,) * 2,
                              reducer_gbps=sim.TEN_GBE, engine=eng))
        assert got["jct_saved"] >= 0.40, got["jct_saved"]
        for k in ("switchagg", "host_only", "jct_switchagg_s",
                  "jct_host_only_s", "jct_saved", "reduction"):
            assert got[k] == want[k], k
        assert got["switchagg"]["delivered_records"] == len(set(keys.tolist()))
        assert got["host_only"]["arrived_records"] == 8 * 1024


@pytest.mark.parametrize("op", OPS)
def test_lossless_delivery_matches_run_cascade(op):
    """loss 0: the delivered table is the port's ``run_cascade`` root."""
    keys = _zipf(600, 64, 2)
    vals = np.random.default_rng(0).standard_normal(600).astype(np.float32)
    _, plan = _plans([32, 16], op)
    res = simulate(sim.JobSpec(keys=keys, values=vals, fanins=(2, 2),
                               plan=plan, cfg=sim.NetConfig(
                                   records_per_packet=32,
                                   engine="vectorized")), device="cpu")
    ref = dataplane.run_cascade(torch.from_numpy(keys),
                                torch.from_numpy(vals), plan)
    real = ref.keys != -1
    assert res.delivered_records == int(real.sum())
    np.testing.assert_array_equal(res.delivered_keys, ref.keys[real].numpy())
    np.testing.assert_allclose(res.delivered_values,
                               ref.values[real].numpy(), rtol=1e-4,
                               atol=1e-5)
    assert res.retransmissions == 0 and res.packets_dropped == 0


def test_host_only_baseline_honors_plan_op_and_loss_costs_time():
    keys = jrm.uniform_keys(256, 16, seed=8).astype(np.int32)
    vals = np.random.default_rng(2).standard_normal(256).astype(np.float32)
    _, plan = _plans([16, 16], "mean")
    cmp = sim.jct_comparison(keys, vals, fanins=(2, 2), plan=plan,
                             cfg=sim.NetConfig(records_per_packet=32),
                             device="cpu")
    assert cmp["host_only"]["op"] == "mean"
    host = cmp["_results"][1]
    want = dict_aggregate(keys, vals, "mean")
    got = host.delivered_table()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    keys = _zipf(1024, 128, 3)
    vals = np.ones_like(keys, np.float32)
    _, plan = _plans([64])
    base, lossy = (simulate(sim.JobSpec(
        keys=keys, values=vals, fanins=(4,), plan=plan,
        cfg=sim.NetConfig(records_per_packet=32, loss_rate=loss, seed=5,
                          engine="vectorized")), device="cpu")
        for loss in (0.0, 0.05))
    assert lossy.retransmissions > 0 and lossy.jct_s > base.jct_s
    assert lossy.delivered_table() == base.delivered_table()
    fb, fl = sim.drain_calibration(base), sim.drain_calibration(lossy)
    assert all(fl[ax] >= fb[ax] for ax in fb)
    assert any(fl[ax] > fb[ax] for ax in fb)


def test_mapper_delay_matches_jax():
    keys = _zipf(2048, 256, 4)
    vals = np.ones_like(keys, np.float32)
    jplan, plan = _plans([128, 128])

    def delay(m):
        return 1e-3 if m == 3 else 0.0

    want = jsimulate(jsim.JobSpec(
        keys=keys, values=vals, fanins=(4, 2), plan=jplan,
        mapper_delay=delay, cfg=jsim.NetConfig(engine="vectorized")))
    for eng in ("node", "vectorized"):
        got = simulate(sim.JobSpec(
            keys=keys, values=vals, fanins=(4, 2), plan=plan,
            mapper_delay=delay, cfg=sim.NetConfig(engine=eng)),
            device="cpu")
        _assert_identical(want, got)
    assert got.mapper_finish_s[3] == max(got.mapper_finish_s)


@pytest.mark.parametrize("loss", [0.0, 0.02])
def test_multi_job_batch_equals_solo_runs(loss):
    """A lockstep batch (two jobs of one signature, one of another op, one
    admitted at step 1) equals each job run alone, and each step's tiers
    of one signature share one ``tier_ingest`` call."""
    _, plan = _plans([64, 64])
    _, plan_max = _plans([64, 64], "max")
    cfg = sim.NetConfig(records_per_packet=16, engine="vectorized",
                        loss_rate=loss, seed=13, window=8)

    def spec(j, p):
        keys = _zipf(8 * 128, 64, 20 + j)
        vals = np.random.default_rng(30 + j).standard_normal(
            keys.shape[0]).astype(np.float32)
        return sim.JobSpec(keys=keys, values=vals, fanins=(4, 2), plan=p,
                           cfg=cfg, job_id=j)

    specs = [spec(0, plan), spec(1, plan), spec(2, plan_max)]
    late = spec(3, plan)
    solo = [simulate(s, device="cpu") for s in specs + [late]]
    before = vsim.ingest_calls
    batch = simulate(specs, admissions=[(1, late)], device="cpu")
    # step 0: level 0 of jobs 0-1 (sum) and 2 (max); step 1: level 1 of
    # jobs 0-1 with level 0 of the late sum job, level 1 of job 2;
    # step 2: level 1 of the late job
    assert vsim.ingest_calls - before == 5
    for s, b in zip(solo, batch):
        _assert_identical(s, b)
    node = simulate(specs[2], engine="node", device="cpu")
    _assert_identical(node, batch[2])


def test_traced_jct_comparison_spans_each_tier_and_job():
    """With the tracer on, a lockstep run leaves one ``vsim.tier_ingest``
    span per aggregating tier (its batch's real pairs are the level's
    ``records_in``; its longest (switch, bucket) run recomputed here with
    the kernel's hash), a ``sim.dispatch`` span naming only the job with
    table work, and host spans for both jobs at every level; the results
    equal the untraced run's."""
    keys = _zipf(8 * 256, 128, 40)
    vals = np.ones_like(keys, np.float32)
    _, plan = _plans([64, 32])
    cfg = sim.NetConfig(records_per_packet=16, engine="vectorized")
    run = lambda: sim.jct_comparison(  # noqa: E731
        keys, vals, fanins=(4, 2), plan=plan, cfg=cfg, device="cpu")
    want = run()
    with obs_trace.scoped_tracer() as tracer:
        got = run()
    for a, b in zip(want["_results"], got["_results"]):
        _assert_identical(a, b)
    assert not obs_trace.get_tracer().events  # the default stays off
    spans = lambda name: [e["args"] for e in tracer.events  # noqa: E731
                          if e["name"] == name]
    tiers = spans("vsim.tier_ingest")
    assert [t["levels"] for t in tiers] == [[0], [1]]
    for t, lv in zip(tiers, got["switchagg"]["per_level"]):
        assert t["real_pairs"] == lv["records_in"]
        assert t["slots"] == t["switches"] * t["packets"] * 16
        assert "fpe_tables_ms" not in t  # device times only on a card
    # level 0: mappers 0-3 feed switch 0, mappers 4-7 switch 1
    _, nb, _ = kvagg._fpe_geometry(64, plan.levels[0].ways)
    h = aggops.hash_key(torch.from_numpy(keys), nb).numpy()
    half = keys.shape[0] // 2
    assert tiers[0]["chain_pairs"] == max(np.bincount(h[:half]).max(),
                                          np.bincount(h[half:]).max())
    assert spans("sim.dispatch") == [{"jobs": ["switchagg"]}] * 2
    for name in ("sim.start_tier", "sim.finish_tier"):
        assert sorted((a["job"], a["level"]) for a in spans(name)) == [
            ("host_only", 0), ("host_only", 1), ("switchagg", 0),
            ("switchagg", 1)]


def test_facade_refuses_what_is_not_ported():
    keys = np.zeros(8, np.int32)
    vals = np.ones(8, np.float32)
    spec = sim.JobSpec(keys=keys, values=vals, fanins=(2,))
    fat_tree = type("FT", (), {"tier_switches": 1, "link_tiers": 1})()
    job_plan = type("JP", (), {"configure": 1, "tree": 1})()
    for x, kw in ((fat_tree, {}), (job_plan, {}), ([job_plan], {}),
                  (spec, {"faults": object()})):
        with pytest.raises(NotImplementedError):
            simulate(x, device="cpu", **kw)
    with pytest.raises(TypeError, match="admissions"):
        simulate(spec, admissions=[(1, spec)], device="cpu")
    with pytest.raises(TypeError, match="own keys"):
        facade.simulate(spec, keys, vals, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            simulate(spec)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.jct_comparison(keys, vals, fanins=(2,))
    cfg = dataclasses.replace(sim.NetConfig(), engine="vectorized")
    assert simulate(spec, cfg=cfg, device="cpu").delivered_records == 1
