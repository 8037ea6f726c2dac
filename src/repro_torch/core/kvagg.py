"""Two-level bounded-memory KV aggregation — the SwitchAgg FPE/BPE hierarchy,
ported to torch (counterpart of ``repro/core/kvagg.py``).

Semantics (paper §4.2.4), unchanged from the JAX package:

  * The **FPE** is a hash table of ``capacity`` slots in fast memory
    (in the CUDA kernel each bucket row is held in registers by the one
    thread or warp that walks that bucket's pairs).  For each incoming
    (key, value) pair: hash the key, probe the bucket; on hit combine; on
    an empty way insert; on a full bucket EVICT way 0 downstream, shift
    the row left and insert at the last way.  The engine never stalls.
  * The **BPE** digests the eviction stream exactly: sort + segment
    reduce (``sorted_combine``).

Every FPE entry point takes ``exact_stream`` (DESIGN.md §8): True is the
paper-faithful sequential scan with a bit-reproducible eviction trace —
on a CUDA tensor it launches the FPE kernel (``kernels.kv_aggregate``),
on a CPU tensor it runs the plain Python loop below; False is the
batched-block fast path, plain torch sorts/searchsorted/cumsums/gathers
that run on either device.

Op semantics come from ``core.aggops`` (DESIGN.md §6).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import aggops

EMPTY_KEY = -1

hash_key = aggops.hash_key

#: int32 range guard of the fast path's composite sort keys
#: (``slot * n + index``).  torch sorts int64, but the JAX package's
#: composites are int32 and past this bound it falls back to the scan —
#: which changes the eviction pattern — so the port keeps the same bound.
_COMPOSITE_LIMIT = 2**31 - 1
_IMAX = 2**31 - 1  # sentinel that sorts after every real composite


class FPEResult(NamedTuple):
    table_keys: torch.Tensor  # [capacity] int32, EMPTY_KEY where vacant
    table_values: torch.Tensor  # [capacity, *lanes]
    evict_keys: torch.Tensor  # [n] int32, EMPTY_KEY where no eviction
    evict_values: torch.Tensor  # [n, *lanes]


def _fpe_geometry(capacity: int, ways: int) -> tuple[int, int, int]:
    """(ways, n_buckets, cap) — THE table-geometry clamp, shared by the
    scan, the batched fast path and the CUDA wrapper.  ``cap`` may be less
    than ``capacity``."""
    ways = max(1, min(ways, capacity))
    n_buckets = max(1, capacity // ways)
    return ways, n_buckets, n_buckets * ways


def fpe_aggregate(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int = 4,
    op: str = "sum",
    exact_stream: bool = True,
    table_keys: torch.Tensor | None = None,
    table_values: torch.Tensor | None = None,
) -> FPEResult:
    """The FPE hash engine: hash-probe-aggregate-or-evict (DESIGN.md §8).

    keys: [n] int32 (EMPTY_KEY entries are skipped — padded streams)
    values: [n] or [n, lanes]
    Returns the resident table plus an eviction stream: [n] slots for the
    scan, [n + cap] for the fast path, EMPTY_KEY where nothing left.

    ``table_keys``/``table_values`` (the flat ``[cap]`` layout a prior call
    returned) resume from a resident table — the streaming ingest of
    ``core.dataplane.LevelState``.  On a CUDA tensor the exact scan is one
    launch of the FPE kernel, resume included.
    """
    if exact_stream:
        return _fpe_scan(keys, values, capacity=capacity, ways=ways, op=op,
                         table_keys=table_keys, table_values=table_values)
    return _fpe_batched(keys, values, capacity=capacity, ways=ways, op=op,
                        table_keys=table_keys, table_values=table_values)


def _fpe_scan(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int,
    op: str,
    table_keys: torch.Tensor | None,
    table_values: torch.Tensor | None,
) -> FPEResult:
    """Paper-faithful FPE: sequential hash-probe-aggregate-or-evict.

    evict_keys[i] is the pair evicted while processing input i.  The FPE
    kernel's wrapper dispatches: the CUDA kernel for a CUDA tensor, the
    plain loop (:func:`_fpe_scan_plain`) for a CPU tensor.
    """
    from repro_torch.kernels import kv_aggregate

    n = keys.shape[0]
    ways, n_buckets, cap = _fpe_geometry(capacity, ways)
    lane_shape = tuple(values.shape[1:])
    lanes = math.prod(lane_shape)
    tk, tv, ek, ev = kv_aggregate.fpe_scan(
        keys.contiguous(), values.reshape(n, lanes).contiguous(),
        n_buckets=n_buckets, ways=ways, op=op,
        table_keys=(None if table_keys is None
                    else table_keys.reshape(cap).contiguous()),
        table_values=(None if table_values is None
                      else table_values.reshape(cap, lanes).contiguous()))
    return FPEResult(tk, tv.reshape((cap,) + lane_shape), ek,
                     ev.reshape((n,) + lane_shape))


def _fpe_scan_plain(keys, values, *, n_buckets: int, ways: int, op: str,
                    table_keys=None, table_values=None):
    """The plain version of the FPE kernel: a Python loop over the stream.

    keys [n] int32, values [n, lanes] (CPU tensors); optional resume table
    [cap] / [cap, lanes].  Returns (table_keys [cap], table_values
    [cap, lanes], evict_keys [n], evict_values [n, lanes]).  Key
    decisions run on Python ints; each value combine is one torch op in
    the value dtype, so the arithmetic is the op's own ``combine``.
    """
    if keys.device.type != "cpu" or values.device.type != "cpu":
        raise ValueError("the plain FPE scan serves only CPU tensors")
    combine = aggops.get(op).combine
    n, lanes = values.shape
    cap = n_buckets * ways
    if table_keys is None:
        rows = [[EMPTY_KEY] * ways for _ in range(n_buckets)]
        tv = torch.zeros((n_buckets, ways, lanes), dtype=values.dtype)
    else:
        rows = table_keys.reshape(n_buckets, ways).tolist()
        tv = table_values.reshape(n_buckets, ways, lanes).clone()
    ek = [EMPTY_KEY] * n
    ev = torch.zeros((n, lanes), dtype=values.dtype)
    vrows = values.unbind(0)
    for i, k in enumerate(keys.tolist()):
        if k == EMPTY_KEY:
            continue
        b = aggops.hash_key_int(k, n_buckets)
        row = rows[b]
        if k in row:  # hit: combine every lane in place
            slot = tv[b, row.index(k)]
            slot.copy_(combine(slot, vrows[i]))
        elif EMPTY_KEY in row:  # miss + free way: insert at the first
            w = row.index(EMPTY_KEY)
            row[w] = k
            tv[b, w] = vrows[i]
        else:  # miss + full: evict way 0, shift left, insert at last way
            ek[i] = row.pop(0)
            row.append(k)
            ev[i] = tv[b, 0]
            tv[b, :-1] = tv[b, 1:].clone()
            tv[b, -1] = vrows[i]
    return (torch.tensor(rows, dtype=torch.int32).reshape(cap),
            tv.reshape(cap, lanes), torch.tensor(ek, dtype=torch.int32), ev)


def _group_reduce(keys, values, *, op):
    """THE bulk group-by-key reduction (DESIGN.md §8): one stable key
    sort + a binary-search segment-id map + one segment reduce.

    Returns (k_s, real_start, comb, pos): keys sorted ascending, True at
    the first sorted occurrence of each real key, each group's combined
    value indexed by the key's FIRST SORTED POSITION (other entries are
    never read), and ``arange(n)``.  ``torch.searchsorted`` is left-side
    by default, as ``jnp.searchsorted(method="scan")`` is, so it maps each
    sorted key to its first position.  The values are reduced in sorted
    order: the sort is stable, so each group still adds in ascending
    stream order (as ``jax.ops.segment_sum`` does) and is one contiguous
    run, which the card's in-order segment sum walks.  The EMPTY_KEY pads
    get id -1 and are dropped: their entries are never read, and on the
    card one thread would otherwise walk them all.
    """
    aggop = aggops.get(op)
    n = keys.shape[0]
    k_s, perm = torch.sort(keys, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    first = torch.searchsorted(k_s, k_s)
    real = k_s != EMPTY_KEY
    real_start = (first == pos) & real
    seg = torch.where(real, first, -1)
    comb = aggop.segment_reduce(values.index_select(0, perm), seg, n,
                                ids_grouped=True)
    return k_s, real_start, comb, pos


def _fpe_batched(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int,
    op: str,
    table_keys: torch.Tensor | None,
    table_values: torch.Tensor | None,
) -> FPEResult:
    """Batched-block FPE fast path (DESIGN.md §8): within-block pre-combine
    + one closed-form vectorized bucket update.

    Each bucket row is a FIFO queue — [residents, new distinct keys] — of
    which the last ``ways`` survive and the prefix is evicted; hits combine
    into their resident way.  The eviction stream is [n + cap] (block
    evictions in distinct-key order, then displaced residents).  Past the
    int32 composite bound ``n * max(n_buckets, cap)`` it falls back to the
    exact scan, padded to the same [n + cap] shape.
    """
    aggop = aggops.get(op)
    combine = aggop.combine
    n = keys.shape[0]
    ways, n_buckets, cap = _fpe_geometry(capacity, ways)
    dev, vdt = keys.device, values.dtype
    if n == 0 or n * max(n_buckets, cap) >= _COMPOSITE_LIMIT:
        res = _fpe_scan(keys, values, capacity=capacity, ways=ways, op=op,
                        table_keys=table_keys, table_values=table_values)
        pad_ev = torch.full((cap,), EMPTY_KEY, dtype=torch.int32, device=dev)
        pad_vv = torch.zeros((cap,) + tuple(values.shape[1:]), dtype=vdt,
                             device=dev)
        return FPEResult(  # keep the fast path's [n + cap] stream shape
            res.table_keys, res.table_values,
            torch.cat([res.evict_keys, pad_ev]),
            torch.cat([res.evict_values, pad_vv]))
    lane_shape = tuple(values.shape[1:])
    lane_nd = len(lane_shape)

    def lanes(m):  # broadcast a mask over trailing lane dims
        return m.reshape(tuple(m.shape) + (1,) * lane_nd)

    zero = torch.zeros((), dtype=vdt, device=dev)
    if table_keys is None:
        tk = torch.full((n_buckets, ways), EMPTY_KEY, dtype=torch.int32,
                        device=dev)
        tv = torch.zeros((n_buckets, ways) + lane_shape, dtype=vdt,
                         device=dev)
    else:
        tk = table_keys.reshape(n_buckets, ways)
        tv = table_values.reshape((n_buckets, ways) + lane_shape)

    # --- stage 1: within-block pre-combine -------------------------------
    k_s, real_start, comb, pos = _group_reduce(keys, values, op=op)

    # --- stage 2: bucket-major distinct stream (one sort) ----------------
    bucket_s = hash_key(k_s, n_buckets).to(torch.int64)
    c1 = torch.sort(torch.where(real_start, bucket_s * n + pos,
                                _IMAX)).values
    valid_d = c1 != _IMAX
    fp = torch.where(valid_d, c1 % n, 0)  # first sorted position of key d
    b_d = torch.where(valid_d, c1 // n, n_buckets)  # ascending buckets
    uk = torch.where(valid_d, k_s[fp], EMPTY_KEY)
    cv = torch.where(lanes(valid_d), comb[fp], zero)

    # --- stage 3: hit detection + FIFO queue arithmetic ------------------
    b_c = b_d.clamp(0, n_buckets - 1)
    rows_k = tk[b_c]  # [n, ways]
    rows_v = tv[b_c]  # [n, ways, *lanes]
    hit = (rows_k == uk[:, None]) & valid_d[:, None]
    is_hit = hit.any(dim=1)
    hit_way = hit.to(torch.int32).argmax(dim=1)  # first hit way
    # resident rows are front-contiguous, so the count locates the queue
    r_d = (rows_k != EMPTY_KEY).sum(dim=1)
    nh = valid_d & ~is_hit  # distinct new keys joining the queue

    sx = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.cumsum(nh.to(torch.int64), dim=0)])
    rs = torch.searchsorted(
        b_d, torch.arange(n_buckets + 1, dtype=torch.int64, device=dev))
    q_arr = sx[rs[1:]] - sx[rs[:-1]]  # [n_buckets] new keys per bucket
    j_d = sx[pos] - sx[rs[b_c]]  # rank of d among its bucket's new keys
    q_d = q_arr[b_c]
    # queue [r residents, q new keys]: evict the first E, keep the last W
    e_d = r_d + q_d - ways
    er_d = torch.minimum(r_d, e_d).clamp(0, ways)  # evicted residents

    hit_surv = is_hit & (hit_way >= er_d)
    hit_evic = is_hit & (hit_way < er_d)  # resident dies before the merge
    new_surv = nh & (j_d >= (e_d - r_d).clamp(min=0))
    # a key whose resident was shift-evicted re-enters the stream as its
    # own pair (the resident pair leaves separately): same grouped total
    self_evict = (nh & ~new_surv) | hit_evic

    way_tgt = torch.where(hit_surv, hit_way - er_d,
                          r_d + j_d - e_d.clamp(min=0))
    writer = hit_surv | new_surv
    rows_v_hit = rows_v[torch.arange(n, device=dev), hit_way.to(torch.int64)]
    wval = torch.where(lanes(is_hit), combine(rows_v_hit, cv), cv)

    # --- stage 4: apply — shift rows, then scatter the <= cap writers ----
    r_b = (tk != EMPTY_KEY).sum(dim=1)
    e_b = torch.minimum(r_b, r_b + q_arr - ways).clamp(0, ways)
    wi = torch.arange(ways, dtype=torch.int64, device=dev)[None, :]
    src = (wi + e_b[:, None]).clamp(0, ways - 1)
    keep = (wi + e_b[:, None]) < ways
    sh_tk = torch.where(keep, torch.gather(tk, 1, src), EMPTY_KEY)
    src_v = src.reshape(tuple(src.shape) + (1,) * lane_nd).expand(tv.shape)
    sh_tv = torch.where(lanes(keep), torch.gather(tv, 1, src_v), zero)

    # every write target (bucket, way) is unique, so there are at most
    # cap writers: one composite sort packs them for a cap-sized scatter
    c2 = torch.sort(torch.where(writer, (b_d * ways + way_tgt) * n + pos,
                                _IMAX)).values[:cap]
    w2 = c2 != _IMAX
    slot2 = (c2 // n)[w2]
    d2 = (c2 % n)[w2]
    flat_k = sh_tk.reshape(cap).clone()
    flat_k[slot2] = uk[d2].to(torch.int32)
    flat_v = sh_tv.reshape((cap,) + lane_shape).clone()
    flat_v[slot2] = wval[d2]

    # --- eviction stream: block self-evictions + displaced residents -----
    ev_k = torch.where(self_evict, uk, EMPTY_KEY).to(torch.int32)
    ev_v = torch.where(lanes(self_evict), cv, zero)
    res_ev = wi < e_b[:, None]  # [n_buckets, ways]
    rv_k = torch.where(res_ev, tk, EMPTY_KEY).reshape(cap)
    rv_v = torch.where(lanes(res_ev), tv, zero).reshape((cap,) + lane_shape)
    return FPEResult(flat_k, flat_v, torch.cat([ev_k, rv_k]),
                     torch.cat([ev_v, rv_v]))


class CombineResult(NamedTuple):
    unique_keys: torch.Tensor  # [n] int32, EMPTY_KEY past n_unique
    combined_values: torch.Tensor  # [n, *lanes]
    n_unique: torch.Tensor  # [] int32


def sorted_combine(keys: torch.Tensor, values: torch.Tensor, *,
                   op: str = "sum") -> CombineResult:
    """Exact combine-by-key via sort + segment reduction (the BPE).
    EMPTY_KEY inputs are ignored.

    Output is fixed-shape [n]: unique keys packed to the front in ascending
    order, EMPTY_KEY padding after ``n_unique`` (padding value slots hold
    the op's dtype-aware identity).  INT32_MAX stays a legal key.
    """
    aggop = aggops.get(op)
    n = keys.shape[0]
    dev = keys.device
    lane_nd = values.dim() - 1
    if n == 0:
        return CombineResult(keys.to(torch.int32), values,
                             torch.zeros((), dtype=torch.int32, device=dev))
    k_s, real_start, comb, pos = _group_reduce(keys, values, op=op)
    # k_s is ascending, so first positions sort to ascending-key order;
    # the rest sort after them as n - 1, an index that is always in range
    fp = torch.sort(torch.where(real_start, pos, n - 1)).values
    n_unique = real_start.sum(dtype=torch.int32)
    valid = pos < n_unique
    valid_l = valid.reshape(tuple(valid.shape) + (1,) * lane_nd)
    ident = aggop.identity(values.dtype)  # a CPU scalar: no copy to dev
    uk = torch.where(valid, k_s.index_select(0, fp), EMPTY_KEY)
    cv = torch.where(valid_l, comb.index_select(0, fp), ident)
    return CombineResult(uk, cv, n_unique)


_KEY_BIAS = 2**31  # int32 key -> [0, 2**32), order kept
_PAD_COMPOSITE = 2**63 - 1  # sorts after every (packet, key) composite


def sorted_combine_packets(keys: torch.Tensor, values: torch.Tensor, *,
                           op: str = "sum") -> CombineResult:
    """:func:`sorted_combine` of every packet of a batch at once: keys
    [G, R], values [G, R, *lanes] -> unique_keys [G, R], combined_values
    [G, R, *lanes], n_unique [G].  Row g is exactly what
    ``sorted_combine(keys[g], values[g])`` returns: the packet's unique
    keys ascending in its first slots, EMPTY_KEY and the op's identity
    after them.

    One stable sort of the (packet, key) composites, then one segment
    reduce over the whole batch (the in-order segment-sum kernel on a
    card for sum/count/mean), then one scatter of the unique keys to
    their packets' slots (one synchronisation, for their count).  The sort is stable, so each key of each
    packet still combines its values in ascending slot order, as the
    per-packet combine does.  :func:`sorted_combine_packets_plain` is the
    loop over packets it must equal bit for bit.
    """
    aggop = aggops.get(op)
    g_n, r = keys.shape
    n = g_n * r
    dev = keys.device
    lane_shape = tuple(values.shape[2:])
    flat_k = keys.reshape(n)
    flat_v = values.reshape((n,) + lane_shape)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    packet = pos // max(r, 1)
    comp = torch.where(flat_k != EMPTY_KEY,
                       (packet << 32) + (flat_k.to(torch.int64) + _KEY_BIAS),
                       _PAD_COMPOSITE)
    c_s, perm = torch.sort(comp, stable=True)
    real = c_s != _PAD_COMPOSITE
    first = torch.searchsorted(c_s, c_s)
    start = (first == pos) & real
    seg = torch.where(real, first, -1)
    comb = aggop.segment_reduce(flat_v.index_select(0, perm), seg, n,
                                ids_grouped=True)
    # the unique keys in (packet, key) order; each one's slot is its rank
    # among its packet's unique keys
    u = start.nonzero().squeeze(1)
    c_u = c_s.index_select(0, u)
    g_u = c_u >> 32
    n_unique = torch.bincount(g_u, minlength=g_n)
    before = torch.cumsum(n_unique, 0) - n_unique  # uniques of lower packets
    slot = g_u * r + torch.arange(u.shape[0], device=dev) - before[g_u]
    uk = torch.full((n,), EMPTY_KEY, dtype=torch.int32, device=dev)
    uk[slot] = ((c_u & 0xFFFFFFFF) - _KEY_BIAS).to(torch.int32)
    cv = aggop.identity(values.dtype, dev).expand((n,) + lane_shape).clone()
    cv[slot] = comb.index_select(0, u)
    return CombineResult(uk.reshape(g_n, r),
                         cv.reshape((g_n, r) + lane_shape),
                         n_unique.to(torch.int32))


def sorted_combine_packets_plain(keys: torch.Tensor, values: torch.Tensor,
                                 *, op: str = "sum") -> CombineResult:
    """The loop over packets that :func:`sorted_combine_packets` equals:
    one :func:`sorted_combine` per row."""
    outs = [sorted_combine(keys[g], values[g], op=op)
            for g in range(keys.shape[0])]
    return CombineResult(*(torch.stack(parts) for parts in zip(*outs)))


class TwoLevelResult(NamedTuple):
    """Full SwitchAgg node output: FPE flush + BPE combine, plus traffic
    stats.  ``out_keys`` is a traffic stream, not a key set: ``n_out``
    counts forwarded pairs (see the JAX package's ``TwoLevelResult``)."""

    out_keys: torch.Tensor  # [capacity + n]
    out_values: torch.Tensor  # [capacity + n, *lanes]
    n_out: torch.Tensor  # [] int32 — forwarded output pairs
    n_in: torch.Tensor  # [] int32 — real input pairs
    n_evict: torch.Tensor  # [] int32 — FPE evictions (pre-BPE traffic)


def two_level_aggregate(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int = 4,
    op: str = "sum",
    bpe: bool = True,
    exact_stream: bool = True,
) -> TwoLevelResult:
    """One SwitchAgg aggregation node: FPE hash stage + optional BPE stage
    (``bpe=False`` forwards evictions unaggregated — the paper's "S-*"
    SRAM-only switch)."""
    fpe = fpe_aggregate(keys, values, capacity=capacity, ways=ways, op=op,
                        exact_stream=exact_stream)
    return assemble_node(keys, fpe.table_keys, fpe.table_values,
                         fpe.evict_keys, fpe.evict_values, op=op, bpe=bpe)


def assemble_node(keys, table_keys, table_values, evict_keys, evict_values,
                  *, op: str, bpe: bool) -> TwoLevelResult:
    """THE node-assembly policy (flush + eviction stream -> output stream),
    shared by the node above, the kernel node (``kernels.ops``) and the
    cascade executor — one copy of the n_out/n_in/n_evict accounting."""
    n_evict = (evict_keys != EMPTY_KEY).sum().to(torch.int32)
    if bpe:
        bpe_out = sorted_combine(evict_keys, evict_values, op=op)
        ok = torch.cat([table_keys, bpe_out.unique_keys])
        ov = torch.cat([table_values, bpe_out.combined_values])
    else:
        ok = torch.cat([table_keys, evict_keys])
        ov = torch.cat([table_values, evict_values])
    n_out = (ok != EMPTY_KEY).sum().to(torch.int32)
    n_in = (keys != EMPTY_KEY).sum().to(torch.int32)
    return TwoLevelResult(ok, ov, n_out, n_in, n_evict)


def n_distinct_keys(keys: torch.Tensor) -> torch.Tensor:
    """Number of distinct non-EMPTY keys in a stream (INT32_MAX legal)."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=keys.device)
    sk = torch.sort(keys).values
    starts = torch.ones_like(sk, dtype=torch.bool)
    starts[1:] = sk[1:] != sk[:-1]
    return (starts & (sk != EMPTY_KEY)).sum().to(torch.int32)


def reduction_ratio(res: TwoLevelResult) -> torch.Tensor:
    """Traffic reduction achieved by the node (paper's R)."""
    return 1.0 - res.n_out / res.n_in.clamp(min=1)


def length_group(key_lengths: torch.Tensor, base: int = 8,
                 n_groups: int = 8) -> torch.Tensor:
    """Payload-analyzer binning (paper §4.2.3): key length L -> group
    index clip(ceil(L/base)-1, 0, G-1)."""
    g = torch.div(key_lengths + base - 1, base, rounding_mode="floor") - 1
    return g.clamp(0, n_groups - 1).to(torch.int32)
