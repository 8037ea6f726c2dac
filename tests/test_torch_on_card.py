"""The port's kernels on a CUDA card against their plain versions.

These tests need a card: without one each skips, with its reason.  On a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_on_card.py

Tolerances: kernel outputs are bit-identical to the plain versions,
except logsumexp (rtol 1e-6, atol 1e-6: the card's expf/log1pf are not
the CPU's).  A whole cascade's values: rtol 1e-6, atol 1e-5, since the
BPE's ``index_add_`` on the card adds in no fixed order.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import aggops, dataplane, kvagg
from repro_torch.core.dataplane import CascadePlan, LevelSpec
from repro_torch.kernels import kv_aggregate, topk_compress

pytestmark = pytest.mark.cuda
EMPTY = -1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions")
    kv_aggregate.launches = topk_compress.launches = 0
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


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.bfloat16), ("max", torch.int32),
    ("min", torch.float32), ("count", torch.int32), ("mean", torch.float32),
    ("logsumexp", torch.float32)])
# 16384 x 4: a shared-memory table past the 48 KB default (opt-in launch);
# 65536 x 4: a table in global memory
@pytest.mark.parametrize("capacity,ways", [(64, 1), (256, 4), (2048, 64),
                                           (16384, 4), (65536, 4)])
def test_fpe_kernel_matches_plain_scan(card, op, dtype, capacity, ways):
    keys, vals = _stream(capacity + ways, 2048, 600, op, dtype)
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
    for g, w in zip(got, want):
        g = g.cpu()
        if op == "logsumexp" and g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("shape,k,dtype", [((64, 4096), 41, torch.float32),
                                           ((13, 100), 7, torch.float32),
                                           ((8, 4096), 41, torch.bfloat16)])
def test_topk_kernel_matches_plain(card, shape, k, dtype):
    x = torch.randn(shape, device=card).to(dtype)
    x[0, :] = 0.0
    x[1, 3::7] = 5.0  # ties go to the lower index
    v, i = topk_compress.topk_rows(x, k=k)
    pv, pi = topk_compress.topk_rows_plain(x, k)
    assert topk_compress.launches == 1
    assert torch.equal(i, pi) and torch.equal(v, pv)


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
    torch.testing.assert_close(got.values.cpu(), want.values, rtol=1e-6,
                               atol=1e-5)
    batches = [(keys[i:i + 59].numpy(), vals[i:i + 59].numpy())
               for i in range(0, 3000, 59)]
    kv_aggregate.launches = 0
    streamed = dataplane.run_cascade_stream(iter(batches), plan, device=card)
    assert kv_aggregate.launches >= len(batches)
    ref = dataplane.run_cascade_stream(iter(batches), plan, device="cpu")
    assert torch.equal(streamed.keys.cpu(), ref.keys)
    assert torch.equal(streamed.level_evict.cpu(), ref.level_evict)
