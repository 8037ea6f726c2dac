"""The port's packet simulator against the JAX package's, on the CPU.

Here: the geometry of ``tests/test_sim_parity.py`` for every op at loss
0 and under loss, both stream modes, and capacity-0 levels;
``tests/test_torch_sim_jobs.py`` has the rest (disabled hops, the
host-only baseline, ``tests/test_net_sim.py``'s word count and loss,
multi-job batches, the facade).  Each job runs through the JAX
package's vectorized engine (which its own tests hold equal to its node
engine) and through both of the port's engines.

Tolerance: exact, under ``_assert_identical`` (``report()``,
``delivered_table()``, ``jct_s``, ``mapper_finish_s``, retransmissions,
drops), except the f32 logsumexp values of the delivered table against
the JAX package, within rtol 1e-6, atol 1e-6 (XLA's f32 exp and log1p
are not correctly rounded, the port's are; ROADMAP §3): the keys and
every report field stay exact.  The port's two engines are held equal
to each other exactly, logsumexp included.
"""

import numpy as np
import pytest

from conftest import dict_aggregate
from repro.core import dataplane as jdp
from repro.core import reduction_model as jrm
from repro.net import sim as jsim
from repro.net import simulate as jsimulate
from repro_torch.core import aggops, dataplane
from repro_torch.net import sim, simulate

OPS = sorted(aggops.names())
LOSS_RATES = (0.005, 0.02, 0.10)


def _plans(caps, op="sum", enabled=None):
    en = enabled if enabled is not None else [True] * len(caps)
    return tuple(
        mod.CascadePlan(op=op, levels=tuple(
            mod.LevelSpec(capacity=c, enabled=e) for c, e in zip(caps, en)))
        for mod in (jdp, dataplane))


def _runs(keys, vals, *, caps, op="sum", enabled=None, aggregate=True,
          fanins=(2, 2), **cfg):
    """(JAX vectorized, port node, port vectorized) results of one job."""
    jplan, plan = _plans(caps, op, enabled)
    kw = dict(keys=keys, values=vals, fanins=fanins, aggregate=aggregate)
    want = jsimulate(jsim.JobSpec(plan=jplan, cfg=jsim.NetConfig(
        engine="vectorized", **cfg), **kw))
    node, vec = (simulate(sim.JobSpec(plan=plan, cfg=sim.NetConfig(
        engine=eng, **cfg), **kw), device="cpu")
        for eng in ("node", "vectorized"))
    return want, node, vec


def _assert_identical(rn, rv):
    """The full parity contract: every observable is exactly equal."""
    assert rv.report() == rn.report()
    assert rv.delivered_table() == rn.delivered_table()
    assert rv.jct_s == rn.jct_s
    assert rv.mapper_finish_s == rn.mapper_finish_s
    assert rv.retransmissions == rn.retransmissions
    assert rv.packets_dropped == rn.packets_dropped


def _assert_matches_jax(want, got, op):
    """``_assert_identical`` but for the f32 logsumexp values."""
    if op != "logsumexp":
        _assert_identical(want, got)
        return
    assert got.report() == want.report()
    assert got.jct_s == want.jct_s
    assert got.mapper_finish_s == want.mapper_finish_s
    np.testing.assert_array_equal(got.delivered_keys, want.delivered_keys)
    np.testing.assert_allclose(got.delivered_values, want.delivered_values,
                               rtol=1e-6, atol=1e-6)


def _assert_three(runs, op):
    want, node, vec = runs
    _assert_identical(node, vec)
    _assert_matches_jax(want, vec, op)


def _zipf(n, variety, seed):
    return jrm.zipf_keys(n, variety, seed=seed).astype(np.int32)


@pytest.mark.parametrize("op", OPS)
def test_lossless_every_op_matches_jax(op):
    """loss 0, both stream modes: the sim_parity geometry."""
    keys = _zipf(600, 64, 2)
    vals = np.random.default_rng(0).standard_normal(600).astype(np.float32)
    for es in (True, False):
        runs = _runs(keys, vals, caps=[32, 16], op=op,
                     records_per_packet=16, exact_stream=es)
        _assert_three(runs, op)
    want = dict_aggregate(keys, vals, op)
    got = runs[2].delivered_table()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("op", OPS)
def test_lossy_every_op_matches_jax(op):
    """0.5% / 2% / 10% loss, both stream modes: the same drops, retransmit
    telemetry and JCTs as the JAX package, and the engines agree."""
    keys = _zipf(600, 64, 2)
    vals = np.random.default_rng(0).standard_normal(600).astype(np.float32)
    saw_retx = False
    for loss in LOSS_RATES:
        for es in (True, False):
            runs = _runs(keys, vals, caps=[32, 16], op=op,
                         records_per_packet=16, exact_stream=es,
                         loss_rate=loss, seed=7, window=8)
            _assert_three(runs, op)
            assert runs[2].duplicate_discards == 0
            saw_retx = saw_retx or runs[2].retransmissions > 0
    assert saw_retx


def test_capacity_zero_levels_take_the_node_path_on_both_engines():
    """Exact unbounded levels (capacity 0) beside an FPE level."""
    keys = _zipf(400, 40, 9)
    vals = np.random.default_rng(1).standard_normal(400).astype(np.float32)
    _assert_three(_runs(keys, vals, caps=[16, 0], records_per_packet=16),
                  "sum")
