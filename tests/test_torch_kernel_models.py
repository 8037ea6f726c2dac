"""Plain models of the port's kernel algorithms, on the CPU.

The CUDA kernels run only on a card.  Their algorithms are modelled in
plain torch beside them, on no path, and held here against the
sequential plain versions and the JAX package:

* ``kv_aggregate.fpe_scan_partitioned_plain``: the FPE kernel's
  bucket-partitioned scan (stable partition by bucket, each bucket's run
  walked in stream order);
* ``topk_compress.topk_rows_radix_plain``: the top-k kernel's radix select
  of the k-th largest magnitude key and its ordered tie fill.

Tolerances: none.  Every comparison is bit for bit, except the model
against the JAX package's FPE for f32 logsumexp, which is exact once
XLA's f32 exp and log1p stand in for the port's correctly rounded ones
(``tests/test_torch_aggops.py`` shows that they are the only difference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggops as jaggops
from repro.core import kvagg as jkvagg
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import aggops, kvagg
from repro_torch.kernels import kv_aggregate, topk_compress

EMPTY = -1
OP_DTYPES = [("sum", "float32"), ("sum", "bfloat16"), ("sum", "int32"),
             ("max", "float32"), ("max", "bfloat16"), ("max", "int32"),
             ("min", "float32"), ("min", "bfloat16"), ("min", "int32"),
             ("count", "int32"), ("mean", "float32"), ("mean", "bfloat16"),
             ("logsumexp", "float32"), ("logsumexp", "bfloat16")]
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}


def _t(x):
    return convert.tensor(x, device="cpu")


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _carried(op, dtype, raw):
    """The op's carried values [n, lanes] (numpy, the JAX package's
    prepare) from raw float values."""
    j = jnp.asarray(raw)
    j = j.astype(jnp.int32) if dtype == "int32" else j.astype(JD[dtype])
    c = np.asarray(jaggops.get(op).prepare_values(j))
    return c.reshape(c.shape[0], -1)


def _stream(seed, n, variety, pad=0.05):
    r = np.random.default_rng(seed)
    keys = r.integers(0, variety, n).astype(np.int32)
    keys[r.random(n) < pad] = EMPTY
    return keys, (r.standard_normal(n) * 4).astype(np.float32) * 25


def _same_bucket_keys(n, n_buckets, bucket=0):
    """n distinct keys that all hash to ``bucket``."""
    out, k = [], 0
    while len(out) < n:
        if aggops.hash_key_int(k, n_buckets) == bucket:
            out.append(k)
        k += 1
    return np.asarray(out, np.int32)


def _model_and_scan(keys, carried, nb, ways, op, table=None):
    kw = dict(n_buckets=nb, ways=ways, op=op)
    if table is not None:
        kw.update(table_keys=table[0], table_values=table[1])
    k, v = _t(keys), _t(carried)
    got = kv_aggregate.fpe_scan_partitioned_plain(k, v, **kw)
    want = kv_aggregate.fpe_scan_plain(k, v, **kw)
    for name, g, w in zip(("table_keys", "table_values", "evict_keys",
                           "evict_values"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name
    return got


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("ways", [1, 4, 8, 64])
@pytest.mark.parametrize("op,dtype", OP_DTYPES)
def test_partitioned_scan_equals_the_sequential_scan(op, dtype, ways, resume):
    nb = max(1, 64 // ways) if ways < 64 else 2
    keys, raw = _stream(ways * 7 + resume, 240, 90)
    carried = _carried(op, dtype, raw)
    table = None
    if resume:
        k0, r0 = _stream(ways + 99, 120, 90)
        table = kv_aggregate.fpe_scan_plain(
            _t(k0), _t(_carried(op, dtype, r0)), n_buckets=nb, ways=ways,
            op=op)[:2]
    _model_and_scan(keys, carried, nb, ways, op, table)


def _xla_transcendentals(monkeypatch):
    for name, fn in (("_exp", jnp.exp), ("_log1p", jnp.log1p)):
        monkeypatch.setattr(
            aggops, name,
            lambda x, fn=fn: _t(np.asarray(fn(jnp.asarray(x.float().numpy())
                                              .astype(JD[str(x.dtype)[6:]])))))


@pytest.mark.parametrize("op,dtype", OP_DTYPES)
def test_partitioned_scan_equals_jax(op, dtype, monkeypatch):
    """Each op and dtype against ``repro.core.kvagg.fpe_aggregate``, the
    geometry rotating over ways 1/4/8/64, resumed from a table."""
    i = OP_DTYPES.index((op, dtype))
    capacity, ways = ((16, 1), (64, 4), (64, 8), (128, 64))[i % 4]
    if op == "logsumexp":
        _xla_transcendentals(monkeypatch)
    keys, raw = _stream(i, 200, 70)
    carried = _carried(op, dtype, raw)
    ways, nb, cap = kvagg._fpe_geometry(capacity, ways)
    j0 = jkvagg.fpe_aggregate(jnp.asarray(keys[:80]),
                              jnp.asarray(carried[:80]), capacity=capacity,
                              ways=ways, op=op)
    jr = jkvagg.fpe_aggregate(jnp.asarray(keys[80:]),
                              jnp.asarray(carried[80:]), capacity=capacity,
                              ways=ways, op=op, table_keys=j0.table_keys,
                              table_values=j0.table_values)
    got = kv_aggregate.fpe_scan_partitioned_plain(
        _t(keys[80:]), _t(carried[80:]), n_buckets=nb, ways=ways, op=op,
        table_keys=_t(j0.table_keys),
        table_values=_t(j0.table_values).reshape(cap, -1))
    for name, g in zip(("table_keys", "table_values", "evict_keys",
                        "evict_values"), got):
        w = _t(getattr(jr, name))
        assert torch.equal(_bits(g.reshape(w.shape)), _bits(w)), name


ADVERSARIAL = ["one_key", "one_bucket_distinct", "all_distinct", "all_pads",
               "empty", "single"]


@pytest.mark.parametrize("ways", [1, 4, 8, 64])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_partitioned_scan_adversarial_streams(case, ways):
    """Chains of the whole stream (one key: all hits; one bucket with
    distinct keys: an eviction per pair past the row), no chain at all
    (pads only, n = 0), n = 1, and all keys distinct."""
    nb, n = 4, 150
    r = np.random.default_rng(len(case) + ways)
    vals = r.standard_normal(n).astype(np.float32)[:, None]
    if case == "one_key":
        keys = np.full(n, 12345, np.int32)
    elif case == "one_bucket_distinct":
        keys = _same_bucket_keys(n, nb, bucket=3)
    elif case == "all_distinct":
        keys = r.permutation(10 * n)[:n].astype(np.int32)
    elif case == "all_pads":
        keys = np.full(n, EMPTY, np.int32)
    elif case == "empty":
        keys, vals = np.zeros(0, np.int32), np.zeros((0, 1), np.float32)
    else:
        keys, vals = np.array([7], np.int32), vals[:1]
    tk, tv, ek, ev = _model_and_scan(keys, vals, nb, ways, "sum")
    real = keys[keys != EMPTY]
    if case == "one_key":
        want_ev = 0
    else:  # distinct keys: each bucket evicts what its row cannot hold
        buckets = [aggops.hash_key_int(int(k), nb) for k in real]
        want_ev = sum(max(0, buckets.count(b) - ways) for b in range(nb))
    assert int((ek != EMPTY).sum()) == want_ev
    assert bool((ev[ek == EMPTY] == 0).all())  # pads and quiet pairs
    # nothing lost: the table and the evictions hold every input key
    held = torch.cat([tk, ek])
    assert set(held[held != EMPTY].tolist()) == set(real.tolist())


def _topk_rows():
    """Rows that stress the radix select: ties, zeros, -0.0, +-inf, NaN
    (NaN ranks above +inf, NaN ties to the lower column), all-equal
    magnitudes, denormals, and random gradients."""
    r = np.random.default_rng(21)
    cols = 96
    x = (r.standard_normal((10, cols)) * 3).astype(np.float32)
    x[0] = 0.0
    x[0, 7::11] = -0.0
    x[1] = 1.5
    x[1, ::2] = -1.5  # all magnitudes equal
    x[2, [3, 40, 41, 90]] = [np.inf, -np.inf, np.nan, np.nan]
    x[3, :] = np.nan
    x[4, 10:20] = 2.0
    x[4, 60:70] = -2.0  # a tie group straddling the threshold
    x[5] = np.float32(1e-40) * r.integers(-3, 4, cols)  # denormals
    x[6, ::3] = x[6, 0]  # repeats of one value
    x[7, 5] = -np.inf
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 41, 64, 96])
def test_radix_select_equals_jax_topk_ref(k, dtype):
    """The model of the top-k kernel against the port's plain version and
    ``repro.kernels.ref.topk_ref``, bit for bit; k = 96 is k = cols.

    Row 5 (denormal magnitudes): XLA flushes denormals to zero, so
    ``topk_ref`` ranks the row as ties in column order, and so does the
    port; both return the values' own bits.
    """
    x = jnp.asarray(_topk_rows()).astype(JD[dtype])
    jv, ji = jref.topk_ref(x, k)
    xt = _t(x)
    mv, mi = topk_compress.topk_rows_radix_plain(xt, k)
    pv, pi = topk_compress.topk_rows_plain(xt, k)
    assert torch.equal(mi, pi)
    assert torch.equal(_bits(mv), _bits(pv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    # values equal, NaN to NaN (XLA's gather may give a NaN another payload)
    np.testing.assert_array_equal(mv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    # the denormal row bit for bit
    np.testing.assert_array_equal(
        _bits(mv[5]).numpy(),
        np.asarray(jv[5]).view(np.int16 if dtype == "bfloat16"
                               else np.int32))


def test_radix_select_keys_order_magnitudes():
    """The keys order |x| as the f32 comparison does, -0.0 as 0 and every
    NaN above +inf."""
    x = torch.tensor([0.0, -0.0, 1e-45, -1.0, 1.0, 3.5, -np.inf, np.inf,
                      np.nan, -np.nan])
    key = topk_compress.magnitude_keys(x)
    assert key[0] == key[1] == 0 and key[3] == key[4]
    assert bool((key[[2, 3, 5, 6]] < key[[3, 5, 6, 8]]).all())
    assert key[6] == key[7] and key[8] == key[9] == topk_compress.NAN_KEY
