"""The port's numpy network modules against the JAX package's: links,
the seeded loss draws, go-back-N ``send_stream``, the receiver gate, and
the vectorized transport of ``net.vsim``.

These modules are numpy copies, so every comparison is exact: the same
drops for the same (seed, flow, psn, attempt), the same float times,
the same byte counters.
"""

import dataclasses

import numpy as np
import pytest

from repro.net import links as jlinks
from repro.net import transport as jtransport
from repro.net import vsim as jvsim
from repro.net import wire as jwire
from repro_torch.net import links, transport, vsim, wire


def _packets(wire_mod, n_pkts, rpp=16, seed=0):
    """A mapper's framed stream (``wire.pack_records``), ready at t=0."""
    r = np.random.default_rng(seed)
    n = n_pkts * rpp - 3
    keys = r.integers(0, 50, n).astype(np.int32)
    vals = r.standard_normal(n).astype(np.float32)
    pkts = wire_mod.pack_records(keys, vals, job_id=0, flow_id=3, level=0,
                                 eot=True, records_per_packet=rpp)
    return [(0.0, p) for p in pkts]


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_loss_draws_equal_the_jax_package(seed):
    """``loss_uniform`` over a [flows, psns, attempts] grid, and the
    scalar ``drop`` against the batched ``drop_array``."""
    f, p, a = np.meshgrid(np.arange(7), np.arange(40), np.arange(1, 4),
                          indexing="ij")
    want = jtransport.loss_uniform(seed, f, p, a)
    got = transport.loss_uniform(seed, f, p, a)
    np.testing.assert_array_equal(got, want)
    lm, jlm = transport.LossModel(0.1, seed), jtransport.LossModel(0.1, seed)
    np.testing.assert_array_equal(lm.drop_array(f, p, a),
                                  jlm.drop_array(f, p, a))
    assert [lm.drop(1, i, 1) for i in range(40)] == \
        [jlm.drop(1, i, 1) for i in range(40)]
    assert not transport.LossModel(0.0, seed).drop_array(f, p, a).any()


def test_link_and_stats_by_axis_equal_the_jax_package():
    out = {}
    for name, mod in (("port", links), ("jax", jlinks)):
        ls = [mod.Link(name=f"l{i}", axis="ab"[i % 2], gbps=1.25 * (i + 1),
                       propagation_s=1e-6) for i in range(4)]
        times = []
        for j, l in enumerate(ls):
            for t in (0.0, 1e-6, 1e-6, 5e-5):
                times.append(l.transmit(t + j * 1e-7, 1500 - 7 * j, 1200))
        out[name] = (times, mod.stats_by_axis(ls))
    assert out["port"] == out["jax"]
    b = type("Budget", (), {"axis": "pod", "gbps": 0.3})()
    assert dataclasses.asdict(links.from_budget(b)) == \
        dataclasses.asdict(jlinks.from_budget(b))
    with pytest.raises(ValueError, match="gbps must be positive"):
        links.Link(name="x", axis="a", gbps=0.0)


@pytest.mark.parametrize("loss", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("window", [1, 4, 16])
def test_send_stream_equals_the_jax_package(loss, window):
    """Delivered (packet, time) sequence, sender-finished time, flow
    stats and link telemetry, at the same seed."""
    runs = {}
    for name, t_mod, l_mod, w_mod in (
            ("port", transport, links, wire),
            ("jax", jtransport, jlinks, jwire)):
        link = l_mod.Link(name="e", axis="lvl0", gbps=1.25)
        got = []
        t_done, st = t_mod.send_stream(
            _packets(w_mod, 23), link, t_mod.LossModel(loss, 9), flow_id=3,
            window=window, deliver=lambda p, t: got.append(
                (p.header.psn, t)))
        runs[name] = (got, t_done, dataclasses.asdict(st),
                      dataclasses.asdict(link))
    assert runs["port"] == runs["jax"]
    if loss == 0.3:  # the draws at this seed do drop packets
        assert runs["port"][2]["retransmissions"] > 0


def test_retry_policy_edge_fault_and_peer_dead():
    """The backoff ladder, the time-based drops, and the verdict a finite
    retry budget raises against a dead peer, as in the JAX package."""
    pol = transport.RetryPolicy(backoff=2.0, max_timeout_s=5.0,
                                max_timeouts=3)
    jpol = jtransport.RetryPolicy(backoff=2.0, max_timeout_s=5.0,
                                  max_timeouts=3)
    assert [pol.rto(1.5, i) for i in range(5)] == \
        [jpol.rto(1.5, i) for i in range(5)]
    f = transport.EdgeFault(dead_from_s=2.0, down_windows=((0.5, 1.0),))
    jf = jtransport.EdgeFault(dead_from_s=2.0, down_windows=((0.5, 1.0),))
    ts = [0.0, 0.5, 0.99, 1.0, 1.99, 2.0, 7.0]
    assert [f.lost(t) for t in ts] == [jf.lost(t) for t in ts]
    errs = []
    for t_mod, l_mod, w_mod, fault, p in (
            (transport, links, wire, f, pol),
            (jtransport, jlinks, jwire, jf, jpol)):
        link = l_mod.Link(name="e", axis="a", gbps=1.25)
        with pytest.raises(t_mod.PeerDeadError) as e:
            t_mod.send_stream(_packets(w_mod, 5), link,
                              t_mod.LossModel(0.0, 0), flow_id=3,
                              deliver=lambda *_: None, retry=p,
                              fault=t_mod.EdgeFault(dead_from_s=0.0))
        errs.append((e.value.t_s, e.value.psn, e.value.timeouts,
                     dataclasses.asdict(e.value.stats)))
    assert errs[0] == errs[1]


def test_receiver_gate_equals_the_jax_package():
    seq = [(0, 0), (0, 1), (1, 0), (0, 1), (0, 3), (0, 2), (1, 1), (1, 1)]
    out = []
    for t_mod, w_mod in ((transport, wire), (jtransport, jwire)):
        rcv = t_mod.Receiver()
        acc = [rcv.accept(w_mod.PacketHeader(
            job_id=0, flow_id=f, level=0, psn=p, n_records=1, eot=False))
            for f, p in seq]
        out.append((acc, rcv.gap_discards, rcv.duplicate_discards))
    assert out[0] == out[1]
    assert out[0][1] == 1 and out[0][2] == 2


@pytest.mark.parametrize("loss", [0.0, 0.02, 0.2])
def test_vectorized_transport_equals_the_jax_package(loss):
    """``transmit_stream`` (loss 0) and ``transmit_stream_lossy`` over an
    array-form stream: arrival times, finish time, stats, telemetry."""
    r = np.random.default_rng(4)
    sizes = r.integers(1, 17, 40).astype(np.int64)
    times = np.sort(r.random(40)) * 1e-4
    n = int(sizes.sum())
    res = {}
    for name, mod, t_mod, l_mod in (("port", vsim, transport, links),
                                    ("jax", jvsim, jtransport, jlinks)):
        ps = mod.PacketStream(job_id=0, flow_id=5, level=0, times=times,
                              sizes=sizes, keys=np.zeros(n, np.int32),
                              values=np.zeros(n, np.float32))
        link = l_mod.Link(name="e", axis="a", gbps=1.25)
        if loss == 0.0:
            arr, dep = mod.transmit_stream(ps, link)
            extra = ()
        else:
            arr, dep, st, gaps = mod.transmit_stream_lossy(
                ps, link, t_mod.LossModel(loss, 3), window=8,
                timeout_s=None)
            extra = (dataclasses.asdict(st), gaps)
        res[name] = (arr.tolist(), dep, extra, dataclasses.asdict(link))
    assert res["port"] == res["jax"]


def test_stream_builders_equal_the_jax_package():
    """Mapper streams (``np.array_split`` framing) and the packet <-> array
    round trip."""
    r = np.random.default_rng(8)
    keys = r.integers(0, 30, 1000).astype(np.int32)
    vals = r.standard_normal(1000).astype(np.float32)
    t0s = [0.0, 1e-6, 0.0, 3e-6, 0.0, 0.0, 2e-6]
    got = vsim.streams_from_mapper_records(keys, vals, t0s, n_mappers=7,
                                           job_id=2, level=0, rpp=59)
    want = jvsim.streams_from_mapper_records(keys, vals, t0s, n_mappers=7,
                                             job_id=2, level=0, rpp=59)
    for g, w in zip(got, want):
        for f in ("job_id", "flow_id", "level", "epoch"):
            assert getattr(g, f) == getattr(w, f)
        for f in ("times", "sizes", "keys", "values"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        back = vsim.stream_from_packets(vsim.stream_to_packets(g),
                                        value_template=vals[:0])
        np.testing.assert_array_equal(back.keys, g.keys)
        np.testing.assert_array_equal(back.sizes, g.sizes)
