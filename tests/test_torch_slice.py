"""The slice end to end at a small size, the port against the JAX package
(CPU): the paper's word count, the compressed gradient exchange, and a
packet stream begun in JAX and finished in the port through
``repro_torch.convert``.

Tolerances: word counts, keys and level counters are exact (f32 sums of
ones below 2**24).  The gradient exchange's dense sums: rtol 1e-6,
atol 1e-6, since the cascade and the dense scatter-add group the same f32
addends in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressor as jcomp
from repro.core import dataplane as jdp
from repro.core import reduction_model as jrm
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import compressor, dataplane as dp
from repro_torch.core import reduction_model as rm
from repro_torch.kernels import ops

EMPTY = -1


def _t(x):
    return convert.tensor(x, device="cpu")


def _two_level(capacity, op="sum"):
    jplan = jdp.CascadePlan(op=op, levels=(
        jdp.LevelSpec(capacity=capacity, ways=4),) * 2)
    return jplan, convert.cascade_plan(jplan)


@pytest.mark.parametrize("capacity", [64, 512])
def test_wordcount_matches_jax_and_bincount(capacity):
    """8 mappers x 512 Zipf-0.99 pairs through a 2-level cascade on the
    kernel backend (its plain scan on the CPU)."""
    n, variety = 8 * 512, 1024
    keys = rm.zipf_keys(n, variety, skew=0.99, seed=0).astype(np.int32)
    ones = np.ones((n,), np.float32)
    jplan, plan = _two_level(capacity)
    jr = jdp.run_cascade(jnp.asarray(keys), jnp.asarray(ones), jplan)
    tr = dp.run_cascade(_t(keys), _t(ones), plan, backend="cuda")
    np.testing.assert_array_equal(tr.keys.numpy(), np.asarray(jr.keys))
    np.testing.assert_array_equal(tr.values.numpy(), np.asarray(jr.values))
    for name in ("level_in", "level_out", "level_evict"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    real = tr.keys != EMPTY
    dense = torch.zeros(variety)
    dense[tr.keys[real].long()] = tr.values[real]
    assert torch.equal(dense, torch.bincount(_t(keys).long(),
                                             minlength=variety).float())


def test_gradient_exchange_matches_jax():
    """8 workers' 64 x 512 gradients: compress_grad (top-k + error
    feedback), a 2-level sum cascade, decompress_sum."""
    workers, shape, chunk, k = 8, (64, 512), 512, 5
    size = shape[0] * shape[1]
    r = np.random.default_rng(0)
    grads = r.standard_normal((workers,) + shape).astype(np.float32)
    jplan, plan = _two_level(64)

    jk, jv, jres = [], [], []
    for g in grads:
        acc = jnp.asarray(g).reshape(-1)
        vals, idx = jref.topk_ref(acc.reshape(-1, chunk), k)
        gk = (idx + jnp.arange(size // chunk, dtype=jnp.int32)[:, None]
              * chunk).reshape(-1)
        jk.append(gk)
        jv.append(vals.reshape(-1))
        jres.append(acc.at[gk].set(0.0))
    jroot = jdp.run_cascade(jnp.concatenate(jk), jnp.concatenate(jv), jplan)
    jdense = jcomp.decompress_sum(jroot.keys, jroot.values, size=size)

    state = compressor.init_state(shape, device="cpu")
    outs = [ops.compress_grad(_t(g), state.residual, k=k, chunk=chunk)
            for g in grads]
    for (tk, tv, tres), gk, gv, gres in zip(outs, jk, jv, jres):
        np.testing.assert_array_equal(tk.numpy(), np.asarray(gk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(gv))
        np.testing.assert_array_equal(tres.reshape(-1).numpy(),
                                      np.asarray(gres))
    troot = dp.run_cascade(torch.cat([o[0] for o in outs]),
                           torch.cat([o[1] for o in outs]), plan,
                           backend="cuda")
    np.testing.assert_array_equal(troot.keys.numpy(), np.asarray(jroot.keys))
    tdense = compressor.decompress_sum(troot.keys, troot.values, size=size)
    np.testing.assert_allclose(tdense.numpy(), np.asarray(jdense),
                               rtol=1e-6, atol=1e-6)
    # and against the plain path: every worker's pairs scatter-added
    plain = np.zeros(size, np.float32)
    for gk, gv in zip(jk, jv):
        np.add.at(plain, np.asarray(gk), np.asarray(gv))
    np.testing.assert_allclose(tdense.numpy(), plain, rtol=1e-6, atol=1e-6)
    assert compressor.compression_ratio(shape, workers * k * size // chunk) \
        == jcomp.compression_ratio(shape, workers * k * size // chunk)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_stream_begun_in_jax_ends_in_the_port(op):
    """Per-level LevelStates run the first packets in JAX, cross over
    (table, counters, the exact node's buffer) and finish in the port."""
    n, rp = 1200, 59
    keys = jrm.zipf_keys(n, 300, seed=4).astype(np.int32)
    vals = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    from repro.core import aggops as jaggops
    carried = np.asarray(jaggops.get(op).prepare_values(jnp.asarray(vals)))
    packets = [(keys[i:i + rp], carried[i:i + rp]) for i in range(0, n, rp)]
    jplan = jdp.CascadePlan(op=op, levels=(
        jdp.LevelSpec(capacity=32, ways=4), jdp.LevelSpec(capacity=0),
        jdp.LevelSpec(capacity=16, ways=2)))
    plan = convert.cascade_plan(jplan)

    def drive(states, batches, root, as_array):
        for k, v in batches:
            for st in states:
                if len(k) == 0:
                    break
                k, v = st.ingest(k, v)
            if len(k):
                root.append((as_array(k), as_array(v)))

    def finish(states, root, as_array):
        for i, st in enumerate(states):
            fk, fv = st.flush()
            drive(states[i + 1:], [(fk, fv)], root, as_array)

    # reference: the whole stream in JAX
    ref_states = [jdp.LevelState(s, op) for s in jplan.levels]
    ref_root = []
    drive(ref_states, packets, ref_root, np.asarray)
    finish(ref_states, ref_root, np.asarray)

    # crossover after 11 packets
    js = [jdp.LevelState(s, op) for s in jplan.levels]
    root = []
    drive(js, packets[:11], root, np.asarray)
    ts = [convert.level_state(s, device="cpu") for s in js]
    assert ts[1]._exact_rows == js[1]._exact_rows > 0
    drive(ts, packets[11:], root, lambda x: x.numpy())
    finish(ts, root, lambda x: x.numpy())

    assert [(s.n_in, s.n_out, s.n_evict) for s in ts] == \
        [(s.n_in, s.n_out, s.n_evict) for s in ref_states]
    got_k = np.concatenate([k for k, _ in root])
    want_k = np.concatenate([k for k, _ in ref_root])
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(np.concatenate([v for _, v in root]),
                                  np.concatenate([v for _, v in ref_root]))


def test_convert_carries_plans_and_states():
    jplan = jdp.CascadePlan(op="max", levels=(
        jdp.LevelSpec(capacity=8, ways=2, bpe=False),
        jdp.LevelSpec(capacity=0, enabled=False)))
    plan = convert.cascade_plan(jplan)
    assert plan == dp.CascadePlan(op="max", levels=(
        dp.LevelSpec(capacity=8, ways=2, bpe=False),
        dp.LevelSpec(capacity=0, enabled=False)))
    st = convert.compressor_state(jcomp.init_state((3, 5)), device="cpu")
    assert st.residual.shape == (3, 5) and st.residual.dtype == torch.float32
    tk, tv = convert.fpe_table(np.array([1, -1], np.int32),
                               jnp.asarray([[1.5], [0.0]]).astype(jnp.bfloat16),
                               device="cpu")
    assert tk.dtype == torch.int32 and tv.dtype == torch.bfloat16
    assert tv.float().tolist() == [[1.5], [0.0]]
    with pytest.raises(ValueError, match="cap"):
        convert.fpe_table(np.zeros(4, np.int32), np.zeros(3, np.float32),
                          device="cpu")
