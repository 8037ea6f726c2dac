"""The port's kernels on a CUDA card against their plain versions.

These tests need a card: without one each skips, with its reason.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_on_card.py

Tolerances: none.  Kernel outputs are bit-identical to the plain
versions, logsumexp included (both compute exp and log1p in f64 and
round to f32), and a whole cascade on the card equals the CPU's bit for
bit, since the BPE's sums add in ascending index order on both.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import aggops, dataplane, kvagg
from repro_torch.core.dataplane import CascadePlan, LevelSpec
from repro_torch.kernels import kv_aggregate, segment_sum, topk_compress

pytestmark = pytest.mark.cuda
EMPTY = -1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions")
    kv_aggregate.launches = topk_compress.launches = 0
    segment_sum.launches = 0
    return torch.device("cuda")


def _stream(seed, n, variety, op, dtype):
    r = np.random.default_rng(seed)
    keys = r.integers(0, variety, n).astype(np.int32)
    keys[r.random(n) < 0.05] = EMPTY
    if dtype == torch.int32:
        raw = torch.from_numpy(r.integers(-100, 100, n).astype(np.int32))
    else:
        raw = torch.from_numpy(r.standard_normal(n).astype(np.float32)
                               ).to(dtype)
    vals = aggops.get(op).prepare_values(raw).reshape(n, -1).contiguous()
    return torch.from_numpy(keys), vals


def _same(got, want):
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():  # bit for bit
            g = g.view(torch.int16 if g.dtype == torch.bfloat16
                       else torch.int32)
            w = w.view(g.dtype)
        assert torch.equal(g, w)


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("max", torch.int32),
    ("min", torch.float32), ("count", torch.int32), ("mean", torch.float32),
    ("logsumexp", torch.float32), ("logsumexp", torch.bfloat16)])
# 64 x 1, 256 x 4: one thread per bucket; 2048 x 64: one warp per bucket
@pytest.mark.parametrize("capacity,ways", [(64, 1), (256, 4), (2048, 64),
                                           (16384, 4), (65536, 4)])
# 2048 pairs: the one-launch path; 6000: the partitioned one
@pytest.mark.parametrize("n", [2048, 6000])
def test_fpe_kernel_matches_plain_scan(card, op, dtype, capacity, ways, n):
    keys, vals = _stream(capacity + ways, n, 600, op, dtype)
    ways, nb, _ = kvagg._fpe_geometry(capacity, ways)
    tk0, tv0, _, _ = kv_aggregate.fpe_scan(keys[:512], vals[:512],
                                           n_buckets=nb, ways=ways, op=op)
    want = kv_aggregate.fpe_scan(keys, vals, n_buckets=nb, ways=ways, op=op,
                                 table_keys=tk0, table_values=tv0)
    got = kv_aggregate.fpe_scan(keys.to(card), vals.to(card), n_buckets=nb,
                                ways=ways, op=op, table_keys=tk0.to(card),
                                table_values=tv0.to(card))
    torch.cuda.synchronize()
    assert kv_aggregate.launches == 1
    _same(got, want)


def _same_bucket_keys(n, n_buckets, bucket=0):
    out, k = [], 0
    while len(out) < n:
        if aggops.hash_key_int(k, n_buckets) == bucket:
            out.append(k)
        k += 1
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("n", [1, 3000, 9000])
@pytest.mark.parametrize("ways", [1, 4, 8, 64])
@pytest.mark.parametrize("case", ["one_key", "one_bucket_distinct",
                                  "all_distinct", "all_pads", "empty"])
def test_fpe_kernel_adversarial_streams(card, case, ways, n):
    """Whole-stream chains (one key; one bucket of distinct keys), all
    keys distinct, pads only, n = 0 and n = 1, on both launch paths."""
    nb = 16
    r = np.random.default_rng(n + ways)
    vals = torch.from_numpy(r.standard_normal((n, 1)).astype(np.float32))
    if case == "one_key":
        keys = np.full(n, 77, np.int32)
    elif case == "one_bucket_distinct":
        keys = _same_bucket_keys(n, nb, bucket=5)
    elif case == "all_distinct":
        keys = r.permutation(4 * n)[:n].astype(np.int32)
    elif case == "all_pads":
        keys = np.full(n, EMPTY, np.int32)
    else:
        keys, vals = np.zeros(0, np.int32), vals[:0]
    keys = torch.from_numpy(keys)
    want = kv_aggregate.fpe_scan(keys, vals, n_buckets=nb, ways=ways,
                                 op="sum")
    got = kv_aggregate.fpe_scan(keys.to(card), vals.to(card), n_buckets=nb,
                                ways=ways, op="sum")
    torch.cuda.synchronize()
    _same(got, want)


@pytest.mark.parametrize("shape,k,dtype", [((64, 4096), 41, torch.float32),
                                           ((13, 100), 7, torch.float32),
                                           ((8, 4096), 41, torch.bfloat16),
                                           ((6, 128), 128, torch.float32),
                                           ((5, 3000), 300, torch.float32)])
def test_topk_kernel_matches_plain(card, shape, k, dtype):
    x = torch.randn(shape, device=card).to(dtype)
    x[0, :] = 0.0
    x[0, 1::5] = -0.0
    x[1, 3::7] = 5.0  # ties go to the lower index
    x[2, [1, 4, 9]] = float("nan")  # NaN ranks above +inf
    x[2, [2, 6]] = float("inf")
    x[3, [0, 8]] = -float("inf")
    x[4, :] = -2.5  # all magnitudes equal
    v, i = topk_compress.topk_rows(x, k=k)
    pv, pi = topk_compress.topk_rows_plain(x, k)
    assert topk_compress.launches == 1
    assert torch.equal(i, pi)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(v.view(bits), pv.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("ids_grouped", [False, True])
def test_segment_sum_kernel_matches_plain(card, dtype, ids_grouped):
    r = np.random.default_rng(3)
    n, segs = 20000, 700
    ids = torch.from_numpy(r.integers(0, segs - 20, n))
    if ids_grouped:
        ids = torch.sort(ids).values
    raw = torch.from_numpy(r.standard_normal((n, 2)).astype(np.float32) * 9)
    vals = raw.to(dtype)
    want = segment_sum.segment_sum_plain(vals, ids, segs)
    got = segment_sum.segment_sum(vals.to(card), ids.to(card), segs,
                                  ids_grouped=ids_grouped)
    assert segment_sum.launches == 1
    _same([got], [want])


def test_kernel_wrappers_refuse_bad_inputs(card):
    keys = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="dtype"):
        kv_aggregate.fpe_scan(keys, torch.zeros((8, 1), dtype=torch.float64,
                                                device=card),
                              n_buckets=2, ways=2, op="sum")
    with pytest.raises(ValueError, match="k=5 > cols=4"):
        topk_compress.topk_rows(torch.zeros((2, 4), device=card), k=5)
    assert kv_aggregate.launches == topk_compress.launches == 0


def test_cascade_and_stream_on_card_match_cpu(card):
    keys, vals = _stream(7, 3000, 500, "sum", torch.float32)
    vals = vals[:, 0].contiguous()
    plan = CascadePlan(op="sum", levels=(LevelSpec(capacity=64),
                                         LevelSpec(capacity=256, ways=8)))
    want = dataplane.run_cascade(keys, vals, plan, backend="cuda")
    got = dataplane.run_cascade(keys.to(card), vals.to(card), plan,
                                backend="cuda")
    assert torch.equal(got.keys.cpu(), want.keys)
    assert torch.equal(got.level_out.cpu(), want.level_out)
    assert torch.equal(got.values.cpu(), want.values)
    batches = [(keys[i:i + 59].numpy(), vals[i:i + 59].numpy())
               for i in range(0, 3000, 59)]
    kv_aggregate.launches = 0
    streamed = dataplane.run_cascade_stream(iter(batches), plan, device=card)
    assert kv_aggregate.launches >= len(batches)
    ref = dataplane.run_cascade_stream(iter(batches), plan, device="cpu")
    assert torch.equal(streamed.keys.cpu(), ref.keys)
    assert torch.equal(streamed.values.cpu(), ref.values)
    assert torch.equal(streamed.level_evict.cpu(), ref.level_evict)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_kernel_ranks_denormals_as_zero(card, dtype):
    """A row of denormal magnitudes ranks as ties in column order (XLA
    flushes denormals), after the row's normal values; the values keep
    their bits."""
    r = np.random.default_rng(5)
    x = torch.from_numpy((np.float32(1e-40) * r.integers(-3, 4, (3, 96))
                          ).astype(np.float32)).to(dtype)
    x[1, [4, 50]] = torch.tensor([2.0, -3.0], dtype=dtype)
    x = x.to(card)
    v, i = topk_compress.topk_rows(x, k=41)
    pv, pi = topk_compress.topk_rows_plain(x.cpu(), 41)
    assert topk_compress.launches == 1
    assert torch.equal(i.cpu(), pi)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(v.cpu().view(bits), pv.view(bits))
    assert i[0].tolist() == list(range(41))
    assert i[1, :2].tolist() == [50, 4]


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("max", torch.int32),
    ("count", torch.int32), ("mean", torch.float32),
    ("logsumexp", torch.float32)])
@pytest.mark.parametrize("capacity,ways", [(64, 4), (256, 8), (16384, 4)])
@pytest.mark.parametrize("s_n,n", [(1, 2000), (3, 1000), (32, 1500)])
def test_fpe_scan_tables_kernel_matches_plain(card, op, dtype, capacity,
                                              ways, s_n, n):
    """One launch over S tables (partitioned whenever S > 1, the
    one-launch path at S = 1 and n <= SMALL_N), resumed, against one
    plain scan per table."""
    streams = [_stream(s + capacity, n, 700, op, dtype) for s in range(s_n)]
    keys = torch.stack([k for k, _ in streams])
    vals = torch.stack([v for _, v in streams])
    ways, nb, _ = kvagg._fpe_geometry(capacity, ways)
    t0 = kv_aggregate.fpe_scan_tables(keys[:, :300], vals[:, :300],
                                      n_buckets=nb, ways=ways, op=op)
    want = kv_aggregate.fpe_scan_tables(keys, vals, n_buckets=nb, ways=ways,
                                        op=op, table_keys=t0[0],
                                        table_values=t0[1])
    got = kv_aggregate.fpe_scan_tables(
        keys.to(card), vals.to(card), n_buckets=nb, ways=ways, op=op,
        table_keys=t0[0].to(card), table_values=t0[1].to(card))
    torch.cuda.synchronize()
    assert kv_aggregate.launches == 1
    _same(got, want)


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("min", torch.int32),
    ("count", torch.int32), ("mean", torch.float32),
    ("logsumexp", torch.float32)])
def test_sorted_combine_packets_on_card_matches_the_loop(card, op, dtype):
    keys, vals = _stream(9, 59 * 300, 40, op, dtype)
    keys = keys.reshape(300, 59)
    keys[7] = EMPTY
    vals = vals.reshape((300, 59) + tuple(vals.shape[1:]))
    if op not in ("mean",):
        vals = vals[..., 0]
    want = kvagg.sorted_combine_packets_plain(keys, vals, op=op)
    got = kvagg.sorted_combine_packets(keys.to(card), vals.to(card), op=op)
    _same(got, want)


@pytest.mark.parametrize("exact_stream", [True, False])
@pytest.mark.parametrize("loss", [0.0, 0.02])
def test_sim_on_card_matches_cpu(card, exact_stream, loss):
    """Both engines on the card equal the vectorized engine on the CPU,
    and the vectorized engine makes one FPE launch per aggregating tier
    in exact-stream mode."""
    from repro_torch.net import sim, simulate

    r = np.random.default_rng(3)
    keys = r.zipf(1.5, 4000).astype(np.int32) % 500
    vals = r.standard_normal(4000).astype(np.float32)
    plan = CascadePlan(op="logsumexp", levels=(LevelSpec(capacity=64),
                                               LevelSpec(capacity=128)))
    cfg = sim.NetConfig(records_per_packet=59, exact_stream=exact_stream,
                        loss_rate=loss, seed=4, window=8)
    spec = sim.JobSpec(keys=keys, values=vals, fanins=(4, 2), plan=plan,
                       cfg=cfg)
    want = simulate(spec, engine="vectorized", device="cpu")
    kv_aggregate.launches = 0
    vec = simulate(spec, engine="vectorized", device=card)
    if exact_stream:
        assert kv_aggregate.launches == 2
    node = simulate(spec, engine="node", device=card)
    for got in (vec, node):
        assert got.report() == want.report()
        assert got.delivered_table() == want.delivered_table()
        assert got.jct_s == want.jct_s
        assert got.mapper_finish_s == want.mapper_finish_s


def test_traced_sim_on_card_records_device_times(card):
    """With the tracer on, each aggregating tier's span carries the device
    times of its FPE launch and of its combine, and the traced run equals
    the untraced one."""
    from repro_torch.net import sim, simulate
    from repro_torch.obs import trace as obs_trace

    keys = np.random.default_rng(5).zipf(1.5, 4000).astype(np.int32) % 500
    vals = np.ones((4000,), np.float32)
    plan = CascadePlan(op="sum", levels=(LevelSpec(capacity=64),) * 2)
    spec = sim.JobSpec(keys=keys, values=vals, fanins=(4, 2), plan=plan,
                       cfg=sim.NetConfig(engine="vectorized"))
    want = simulate(spec, device=card)
    with obs_trace.scoped_tracer() as tracer:
        got = simulate(spec, device=card)
    assert got.report() == want.report()
    assert got.delivered_table() == want.delivered_table()
    tiers = [e["args"] for e in tracer.events
             if e["name"] == "vsim.tier_ingest"]
    assert [t["levels"] for t in tiers] == [[0], [1]]
    for t in tiers:
        assert t["fpe_tables_ms"] > 0.0 and t["combine_ms"] > 0.0
