"""repro_torch.core.reduction_model against repro.core.reduction_model.

The port keeps a numpy copy (the JAX package's module imports no jax but
lives in a package that does), so every number is exact: Eq. 1-3 over a
sweep, the stream simulators, and the seeded key generators.
"""

import numpy as np
import pytest

from repro.core import reduction_model as jrm
from repro.net import wire as jwire
from repro_torch.core import reduction_model as rm
from repro_torch.net import wire


@pytest.mark.parametrize("m,n,c", [(4096, 512, 64), (4096, 512, 512),
                                   (1000, 1000, 0), (10**6, 2**17, 16384),
                                   (7, 1, 1), (1e9, 1e6, 1e7)])
def test_eq3_matches(m, n, c):
    assert rm.reduction_ratio(m, n, c) == jrm.reduction_ratio(m, n, c)
    assert rm.reduction_ratio_bound(n, c) == jrm.reduction_ratio_bound(n, c)


def test_eq3_rejects_the_same_inputs():
    for args in ((0, 1, 1), (10, 0, 1), (10, 5, -1), (5, 10, 1)):
        with pytest.raises(ValueError):
            jrm.reduction_ratio(*args)
        with pytest.raises(ValueError):
            rm.reduction_ratio(*args)


def test_eq1_eq2_match():
    for slot, pairs in ((64, [8, 16, 64]), (32, [32]), (128, [1, 2, 3])):
        assert rm.fixed_format_extra_traffic(slot, pairs) == \
            jrm.fixed_format_extra_traffic(slot, pairs)
        assert rm.switchagg_extra_traffic(pairs) == \
            jrm.switchagg_extra_traffic(pairs)
    for d, mp in ((10**6, 229), (1500, 1442), (0, 100)):
        assert rm.header_overhead_bytes(d, mp) == \
            jrm.header_overhead_bytes(d, mp)
        assert rm.header_overhead_ratio(mp) == jrm.header_overhead_ratio(mp)
    with pytest.raises(ValueError):
        rm.fixed_format_extra_traffic(8, [9])


@pytest.mark.parametrize("gen", ["uniform_keys", "zipf_keys"])
@pytest.mark.parametrize("m,n,seed", [(1000, 64, 0), (4096, 4096, 3),
                                      (10, 100000, 7)])
def test_generators_are_identical(gen, m, n, seed):
    got = getattr(rm, gen)(m, n, seed=seed)
    want = getattr(jrm, gen)(m, n, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("caps,ways", [((64,), 4), ((16, 64, 8), 2),
                                       ((1, 1), 1)])
def test_simulate_chain_matches(caps, ways):
    keys = jrm.zipf_keys(2000, 300, seed=1)
    vals = np.random.default_rng(1).standard_normal(2000)
    r_got, s_got = rm.simulate_chain(keys, vals, caps, ways=ways)
    r_want, s_want = jrm.simulate_chain(keys, vals, caps, ways=ways)
    assert r_got == r_want
    assert [(s.input_pairs, s.output_pairs) for s in s_got] == \
        [(s.input_pairs, s.output_pairs) for s in s_want]
    st, out = rm.simulate_node(keys, None, caps[0], ways=ways)
    jst, jout = jrm.simulate_node(keys, None, caps[0], ways=ways)
    assert (st.input_pairs, st.output_pairs, st.reduction) == \
        (jst.input_pairs, jst.output_pairs, jst.reduction)
    assert out == jout


def test_merge_flows_and_traffic_model_match():
    flows = [np.arange(5), np.arange(10, 13), np.arange(20, 28)]
    np.testing.assert_array_equal(rm.merge_flows(flows),
                                  jrm.merge_flows(flows))
    for fanins in ((16, 2), (4, 2, 8), (2,)):
        a = rm.TreeTrafficModel(grad_bytes=10**8, fanins=fanins)
        b = jrm.TreeTrafficModel(grad_bytes=10**8, fanins=fanins)
        assert a.flat_bytes_per_level() == b.flat_bytes_per_level()
        assert a.tree_bytes_per_level() == b.tree_bytes_per_level()
        assert a.tree_reduction_at_root() == b.tree_reduction_at_root()


def test_wire_constants_are_copied():
    names = [n for n in dir(jwire) if n.isupper()]
    assert "RECORDS_PER_PACKET" in names
    for name in names:
        assert getattr(wire, name) == getattr(jwire, name), name
    assert wire.RECORDS_PER_PACKET == 59
