"""The port's vectorized tier engine against the JAX package's, on the
CPU (plain versions of the kernels).

* ``vsim.tier_ingest`` against ``repro.net.vsim.tier_ingest`` on
  ``[S, P, R]`` batches with pad packets: every op, both stream modes,
  f32 and bf16 (int32 for count), with and without the BPE;
* the multi-table scan ``kv_aggregate.fpe_scan_tables`` and the model of
  its one-launch algorithm (S tables side by side, bucket ids offset by
  table) against one scan per table, and one scan against the same
  stream fed packet by packet with the table resumed;
* the batched combine ``kvagg.sorted_combine_packets`` against the
  per-packet ``sorted_combine`` loop.

Tolerances: none, except the f32 logsumexp values against the JAX
package (rtol 1e-6, atol 1e-6): XLA's f32 exp and log1p are not
correctly rounded, the port's are (ROADMAP §3); the keys, tables'
keys, eviction counts and output counts stay exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggops as jaggops
from repro.net import vsim as jvsim
from repro_torch import convert
from repro_torch.core import aggops, kvagg
from repro_torch.kernels import kv_aggregate
from repro_torch.net import vsim

EMPTY = -1
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
OP_DTYPES = [("sum", "float32"), ("sum", "bfloat16"), ("max", "float32"),
             ("max", "bfloat16"), ("min", "float32"), ("min", "bfloat16"),
             ("count", "int32"), ("mean", "float32"), ("mean", "bfloat16"),
             ("logsumexp", "float32"), ("logsumexp", "bfloat16")]
#: every (op, dtype) in both modes; the BPE on for two cases of three
CASES = [(op, dt, exact, i % 3 != 2)
         for i, (op, dt) in enumerate(OP_DTYPES) for exact in (True, False)]


def _t(x):
    return convert.tensor(x, device="cpu")


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _batch(seed, s_n=3, p_n=5, r=8, variety=24):
    """keys [S, P, R] with EMPTY pads inside packets and, given 3 switches
    and 4 packets, whole pad packets (switch 1 ends early, switch 2 has a
    pad packet in the middle); raw f32 values [S, P, R]."""
    g = np.random.default_rng(seed)
    keys = g.integers(0, variety, (s_n, p_n, r)).astype(np.int32)
    keys[g.random(keys.shape) < 0.1] = EMPTY
    if s_n > 2 and p_n > 3:
        keys[1, 3:] = EMPTY
        keys[2, 1] = EMPTY
    raw = (g.standard_normal(keys.shape) * 3).astype(np.float32)
    return keys, raw


def _carried(op, dtype, raw):
    """The op's carried values (numpy, the JAX package's prepare)."""
    j = jnp.asarray(raw.reshape(-1))
    j = j.astype(jnp.int32) if dtype == "int32" else j.astype(JD[dtype])
    c = jaggops.get(op).prepare_values(j)
    return c.reshape(raw.shape + c.shape[1:])


@pytest.mark.parametrize("op,dtype,exact_stream,bpe", CASES)
def test_tier_ingest_matches_jax(op, dtype, exact_stream, bpe):
    keys, raw = _batch(len(op) + 3 * exact_stream)
    vals = _carried(op, dtype, raw)
    kw = dict(capacity=16, ways=4, op=op, bpe=bpe, exact_stream=exact_stream)
    want = jvsim.tier_ingest(jnp.asarray(keys), vals, **kw)
    got = vsim.tier_ingest(_t(keys), _t(vals), **kw)
    names = ("table_keys", "table_values", "evict_keys", "evict_values",
             "n_evict", "n_out")
    for name, g, w in zip(names, got, want):
        w = _t(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if op == "logsumexp" and dtype == "float32" and "values" in name:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        else:
            assert torch.equal(_bits(g), _bits(w)), name
    assert int(got[4].max()) <= keys.shape[2]


@pytest.mark.parametrize("op,dtype", [("sum", torch.float32),
                                      ("max", torch.bfloat16),
                                      ("count", torch.int32),
                                      ("mean", torch.float32),
                                      ("logsumexp", torch.float32)])
@pytest.mark.parametrize("capacity,ways", [(16, 4), (8, 1), (64, 8)])
def test_fpe_scan_tables_is_one_scan_per_table(op, dtype, capacity, ways):
    """The plain multi-table scan, and the model of the kernel's one
    launch over the tables side by side (``fpe_scan_partitioned_plain``
    with ``n_tables``), equal one ``fpe_scan`` per table, resumed tables
    included."""
    s_n, n = 3, 90
    keys, raw = _batch(capacity + ways, s_n=s_n, p_n=1, r=n)
    keys, raw = keys[:, 0], raw[:, 0]
    vals = aggops.get(op).prepare_values(
        torch.from_numpy(raw.reshape(-1)).to(dtype)).reshape(s_n, n, -1)
    keys = torch.from_numpy(keys)
    ways, nb, cap = kvagg._fpe_geometry(capacity, ways)
    t0 = kv_aggregate.fpe_scan_tables(keys[:, :30], vals[:, :30],
                                      n_buckets=nb, ways=ways, op=op)
    got = kv_aggregate.fpe_scan_tables(keys, vals, n_buckets=nb, ways=ways,
                                       op=op, table_keys=t0[0],
                                       table_values=t0[1])
    lanes = vals.shape[2]
    model = kv_aggregate.fpe_scan_partitioned_plain(
        keys.reshape(-1), vals.reshape(-1, lanes), n_buckets=nb, ways=ways,
        op=op, table_keys=t0[0].reshape(-1),
        table_values=t0[1].reshape(-1, lanes), n_tables=s_n)
    model = (model[0].reshape(s_n, cap), model[1].reshape(s_n, cap, lanes),
             model[2].reshape(s_n, n), model[3].reshape(s_n, n, lanes))
    for s in range(s_n):
        want = kv_aggregate.fpe_scan(keys[s], vals[s], n_buckets=nb,
                                     ways=ways, op=op, table_keys=t0[0][s],
                                     table_values=t0[1][s])
        for g, m, w in zip(got, model, want):
            assert torch.equal(_bits(g[s]), _bits(w))
            assert torch.equal(_bits(m[s]), _bits(w))


@pytest.mark.parametrize("op", ["sum", "max", "logsumexp"])
def test_one_scan_equals_the_packets_resumed(op):
    """Stepping a switch packet by packet, the table resumed each time,
    equals one scan over the concatenated packets: the same table, and
    packet p's eviction stream is slots [p R, (p + 1) R) of the one."""
    keys, raw = _batch(5, s_n=1, p_n=9, r=16, variety=40)
    k = torch.from_numpy(keys[0].reshape(-1))
    v = aggops.get(op).prepare_values(
        torch.from_numpy(raw[0].reshape(-1))).reshape(-1, 1)
    one = kv_aggregate.fpe_scan(k, v, n_buckets=4, ways=2, op=op)
    tk = tv = None
    for p in range(9):
        sl = slice(16 * p, 16 * (p + 1))
        tk, tv, ek, ev = kv_aggregate.fpe_scan(
            k[sl], v[sl], n_buckets=4, ways=2, op=op, table_keys=tk,
            table_values=tv)
        assert torch.equal(ek, one[2][sl])
        assert torch.equal(_bits(ev), _bits(one[3][sl]))
    assert torch.equal(tk, one[0]) and torch.equal(_bits(tv),
                                                   _bits(one[1]))
    assert int((one[2] != EMPTY).sum()) > 0


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("max", torch.float32),
    ("min", torch.int32), ("count", torch.int32), ("mean", torch.float32),
    ("logsumexp", torch.float32), ("logsumexp", torch.bfloat16)])
def test_sorted_combine_packets_equals_the_loop(op, dtype):
    """Every packet's unique keys in the same slots, EMPTY_KEY and the
    op's identity after them, the values bit for bit; packets of pads
    only and the INT32_MAX key included."""
    keys, raw = _batch(11, s_n=1, p_n=40, r=12, variety=9)
    keys = keys[0]
    keys[3] = EMPTY
    keys[5, 2] = 2**31 - 1
    keys[6, :] = 7  # one key repeated over a whole packet
    raw = raw[0]
    if dtype == torch.int32:
        raw = np.round(raw * 10)
    vals = aggops.get(op).prepare_values(
        torch.from_numpy(raw.reshape(-1)).to(dtype))
    vals = vals.reshape((40, 12) + tuple(vals.shape[1:]))
    keys = torch.from_numpy(keys)
    got = kvagg.sorted_combine_packets(keys, vals, op=op)
    want = kvagg.sorted_combine_packets_plain(keys, vals, op=op)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
    assert int(got.n_unique[3]) == 0 and int(got.n_unique[6]) == 1


def test_dispatch_batches_tiers_by_signature():
    """Two works of one signature share one call, a third of another op
    gets its own; each work's slice equals its solo dispatch."""
    from repro_torch.core import dataplane
    from repro_torch.net import sim

    cfg = sim.NetConfig(records_per_packet=8)

    def work(op, seed, fanin=2):
        g = np.random.default_rng(seed)
        keys = g.integers(0, 20, 200).astype(np.int32)
        vals = aggops.get(op).prepare_values(torch.from_numpy(
            g.standard_normal(200).astype(np.float32))).numpy()
        streams = vsim.streams_from_mapper_records(
            keys, vals, [0.0] * 4, n_mappers=4, job_id=seed, level=0, rpp=8)
        return vsim.tier_start(
            streams, level=0, fanin=fanin,
            spec=dataplane.LevelSpec(capacity=16), op=op, cfg=cfg,
            axis="lvl0", gbps=1.25, job_id=seed, first_flow_id=4,
            value_template=vals[:0], device=torch.device("cpu"))

    works = [work("sum", 1), work("sum", 2), work("max", 3)]
    before = vsim.ingest_calls
    assert vsim.dispatch_tier_ingest(works) == 2
    assert vsim.ingest_calls - before == 2
    for wk, seed, op in zip(works, (1, 2, 3), ("sum", "sum", "max")):
        solo = work(op, seed)
        vsim.dispatch_tier_ingest([solo])
        for a, b in zip(wk.kernel_out, solo.kernel_out):
            np.testing.assert_array_equal(a, b)
