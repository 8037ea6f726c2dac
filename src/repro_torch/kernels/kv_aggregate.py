"""The SwitchAgg FPE hash-combine engine on Hopper: CUDA C++ kernel wrapper.

Port of the Pallas TPU kernel ``_fpe_kernel`` / ``fpe_aggregate_pallas``
(``src/repro/kernels/kv_aggregate.py:62`` and ``:151``).  The kernel is
``csrc/fpe_aggregate.cu``; its source note says how the TPU design (a
VMEM table carried across a sequential grid) becomes a bucket-parallel
scan: the pairs are partitioned by bucket (stream order kept within a
bucket) and each bucket's run is walked by one thread (its row in
registers) or, for rows of more than 4 ways, one warp.  What bounds it is
the longest bucket chain, not bandwidth.  A stream of at most
``SMALL_N`` pairs is one launch that partitions in shared memory.
:func:`fpe_scan_tables` runs S independent tables (every switch of a
simulated tier) in one launch: the S tables side by side are one table
of ``S * n_buckets`` buckets, table s owning stream slice s.

Semantics are bit-identical to the sequential scan ``core.kvagg._fpe_scan``
whose plain form, :func:`fpe_scan_plain`, is the Python loop in
``core.kvagg`` (the oracle the kernel is held against on the card).
:func:`fpe_scan_partitioned_plain` is the plain model of the kernel's
algorithm, on no path: the tests hold it against the scan.

Dispatch rule (no fallbacks): a CPU tensor takes the plain scan; a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else; ``table_launches`` counts those made by
:func:`fpe_scan_tables`.

``exact_stream=False`` in :func:`fpe_aggregate_cuda` keeps the Pallas
wrapper's fast-mode contract (DESIGN.md §8): the stream is pre-combined
with ``kvagg.sorted_combine`` and the distinct keys stream through the
kernel; the eviction stream stays ``[n]`` (slot d = the d-th sorted
distinct key), unlike ``kvagg``'s ``[n + cap]`` fast path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import aggops
from repro_torch.core import kvagg as _kvagg

from . import _build

EMPTY_KEY = -1

#: op name -> the kernel's op code (count and mean are sums over their
#: carried lanes)
OP_CODES = {"sum": 0, "count": 0, "mean": 0, "max": 1, "min": 2,
            "logsumexp": 3}
#: value dtype -> the kernel's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
MAX_LANES = 4
#: the longest stream the one-launch path takes: ``kSmallN`` in the .cu,
#: which refuses a longer stream passed without its partition
SMALL_N = 4096

#: kernel launches in this process (set to 0 to start a count)
launches = 0
#: of those, the multi-table launches of :func:`fpe_scan_tables`
table_launches = 0

fpe_scan_plain = _kvagg._fpe_scan_plain


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("fpe_aggregate")
    if lib.fpe_aggregate_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fpe_aggregate_launch.argtypes = [p, p, i, i, i, i, i, i,
                                             p, p, p, p, p, p,
                                             p, p, p, p, p]
        lib.fpe_aggregate_launch.restype = i
        lib.fpe_bucket_launch.argtypes = [p, i, i, i, p, p]
        lib.fpe_bucket_launch.restype = i
    return lib


def fpe_scan_partitioned_plain(keys, values, *, n_buckets: int, ways: int,
                               op: str, table_keys=None, table_values=None,
                               n_tables: int = 1):
    """Plain model of the kernel's algorithm (CPU tensors; tests only).

    Partition: each pair's bucket (pads past the last), a stable sort,
    each bucket's run.  Walk: each bucket's row from the resume table (or
    empty), its run applied in order, each eviction written at the pair's
    own stream index, the row written once.  Returns what
    :func:`fpe_scan_plain` returns, and must equal it bit for bit.  With
    ``n_tables`` tables side by side (the multi-table launch), table s
    owns stream slice s and the buckets from ``s * n_buckets``, and the
    result equals one :func:`fpe_scan_plain` per table.
    """
    combine = aggops.get(op).combine
    n, lanes = values.shape
    table = torch.arange(n) // max(1, n // n_tables)
    n_buckets_per = n_buckets
    n_buckets = n_tables * n_buckets
    bkt = torch.where(keys == EMPTY_KEY, n_buckets,
                      table * n_buckets_per
                      + aggops.hash_key(keys, n_buckets_per))
    perm = torch.sort(bkt, stable=True).indices
    starts = torch.searchsorted(bkt[perm], torch.arange(n_buckets + 1,
                                                        dtype=bkt.dtype))
    if table_keys is None:
        tk = torch.full((n_buckets, ways), EMPTY_KEY, dtype=torch.int32)
        tv = torch.zeros((n_buckets, ways, lanes), dtype=values.dtype)
    else:
        tk = table_keys.reshape(n_buckets, ways).clone()
        tv = table_values.reshape(n_buckets, ways, lanes).clone()
    ek = torch.full((n,), EMPTY_KEY, dtype=torch.int32)
    ev = torch.zeros((n, lanes), dtype=values.dtype)
    for b in range(n_buckets):
        rk, rv = tk[b].tolist(), tv[b].clone()  # the worker's "registers"
        for i in perm[starts[b]:starts[b + 1]].tolist():
            k, x = int(keys[i]), values[i]
            if k in rk:
                w = rk.index(k)
                rv[w] = combine(rv[w], x)
            elif EMPTY_KEY in rk:
                w = rk.index(EMPTY_KEY)
                rk[w], rv[w] = k, x
            else:
                ek[i], ev[i] = rk[0], rv[0]
                rk = rk[1:] + [k]
                rv = torch.cat([rv[1:], x[None]])
        tk[b], tv[b] = torch.tensor(rk, dtype=torch.int32), rv
    return tk.reshape(-1), tv.reshape(-1, lanes), ek, ev


def _check(t: torch.Tensor, name: str, dev, dtype, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def partition(keys: torch.Tensor, n_buckets: int, n_tables: int = 1):
    """The kernel's partition of a stream on the card: (perm [n] int64,
    the stream indices ordered by bucket with stream order kept within a
    bucket; starts [n_tables * n_buckets + 1] int64, each bucket's run in
    perm).  With ``n_tables`` tables, table s owns the stream slice
    [s * n / n_tables, (s + 1) * n / n_tables) and the buckets from
    ``s * n_buckets``.  Pads go past the last run."""
    n = keys.shape[0]
    total = n_tables * n_buckets
    bkt = torch.empty((n,), dtype=torch.int32, device=keys.device)
    with _build.on_device(keys.device):
        rc = _lib().fpe_bucket_launch(
            keys.data_ptr(), n, n // n_tables, n_buckets, bkt.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"FPE bucket launch failed: cudaError {rc}")
    sb, perm = torch.sort(bkt, stable=True)
    starts = torch.searchsorted(
        sb, torch.arange(total + 1, dtype=torch.int32, device=keys.device))
    return perm, starts


def _launch(keys, values, *, n_buckets, ways, op, table_keys, table_values,
            n_tables=1):
    """One kernel launch over ``n_tables`` tables side by side: keys [n],
    values [n, lanes], table [n_tables * cap] (see :func:`partition`)."""
    global launches
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the FPE kernel needs CUDA tensors, got {dev}")
    if values.dim() != 2:
        raise ValueError("values must be [n, lanes]")
    n, lanes = values.shape
    if values.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported value dtype {values.dtype}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lanes must be in [1, {MAX_LANES}], got {lanes}")
    if op not in OP_CODES:
        aggops.get(op)  # raises, listing the registered ops
        raise ValueError(f"op {op!r} has no FPE kernel")
    if op == "logsumexp" and not values.dtype.is_floating_point:
        raise ValueError("logsumexp needs floating values")
    if n >= 2**31 or n % n_tables:
        raise ValueError(f"{n} pairs do not split into {n_tables} tables "
                         "of a stream the kernel can index (int32)")
    cap = n_tables * n_buckets * ways
    _check(keys, "keys", dev, torch.int32, (n,))
    _check(values, "values", dev, values.dtype, (n, lanes))
    if (table_keys is None) != (table_values is None):
        raise ValueError("pass both table_keys and table_values, or neither")
    if table_keys is not None:
        _check(table_keys, "table_keys", dev, torch.int32, (cap,))
        _check(table_values, "table_values", dev, values.dtype, (cap, lanes))
    out_tk = torch.empty((cap,), dtype=torch.int32, device=dev)
    out_tv = torch.empty((cap, lanes), dtype=values.dtype, device=dev)
    ek = torch.empty((n,), dtype=torch.int32, device=dev)
    ev = torch.empty((n, lanes), dtype=values.dtype, device=dev)
    lib = _lib()
    with _build.on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = (None,) * 4
        # the one-launch path hashes without a table offset
        if n > SMALL_N or n_tables > 1:
            perm, starts = partition(keys, n_buckets, n_tables)
            run_k = torch.empty_like(keys)
            run_v = torch.empty_like(values)
            part = (perm.data_ptr(), starts.data_ptr(), run_k.data_ptr(),
                    run_v.data_ptr())
        rc = lib.fpe_aggregate_launch(
            keys.data_ptr(), values.data_ptr(), n, lanes,
            n_tables * n_buckets, ways,
            OP_CODES[op], DTYPE_CODES[values.dtype],
            None if table_keys is None else table_keys.data_ptr(),
            None if table_values is None else table_values.data_ptr(),
            out_tk.data_ptr(), out_tv.data_ptr(), ek.data_ptr(),
            ev.data_ptr(), *part, stream)
    if rc != 0:
        raise RuntimeError(f"FPE kernel launch failed: cudaError {rc}")
    launches += 1
    return out_tk, out_tv, ek, ev


def fpe_scan(keys, values, *, n_buckets: int, ways: int, op: str,
             table_keys=None, table_values=None):
    """One exact FPE scan over keys [n] / values [n, lanes], optionally
    resumed from a table [cap] / [cap, lanes].  Returns (table_keys [cap],
    table_values [cap, lanes], evict_keys [n], evict_values [n, lanes]).

    CPU tensors take the plain loop; CUDA tensors launch the kernel.
    """
    if keys.device.type == "cpu":
        return fpe_scan_plain(keys, values, n_buckets=n_buckets, ways=ways,
                              op=op, table_keys=table_keys,
                              table_values=table_values)
    return _launch(keys, values, n_buckets=n_buckets, ways=ways, op=op,
                   table_keys=table_keys, table_values=table_values)


def fpe_scan_tables_plain(keys, values, *, n_buckets: int, ways: int,
                          op: str, table_keys=None, table_values=None):
    """The plain version of :func:`fpe_scan_tables`: one
    :func:`fpe_scan_plain` per table (CPU tensors)."""
    outs = [fpe_scan_plain(
        keys[s], values[s], n_buckets=n_buckets, ways=ways, op=op,
        table_keys=None if table_keys is None else table_keys[s],
        table_values=None if table_values is None else table_values[s])
        for s in range(keys.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def fpe_scan_tables(keys, values, *, n_buckets: int, ways: int, op: str,
                    table_keys=None, table_values=None):
    """S independent exact FPE scans in one launch: keys [S, n], values
    [S, n, lanes], optionally resumed from tables [S, cap] /
    [S, cap, lanes].  Returns (table_keys [S, cap], table_values
    [S, cap, lanes], evict_keys [S, n], evict_values [S, n, lanes]); row s
    is exactly ``fpe_scan(keys[s], values[s], ...)``.

    CPU tensors take :func:`fpe_scan_tables_plain`; CUDA tensors launch
    the kernel once over the S tables side by side (``S * n_buckets``
    buckets, partitioned).
    """
    if keys.device.type == "cpu":
        return fpe_scan_tables_plain(keys, values, n_buckets=n_buckets,
                                     ways=ways, op=op, table_keys=table_keys,
                                     table_values=table_values)
    global table_launches
    if keys.dim() != 2 or values.dim() != 3:
        raise ValueError("keys must be [S, n] and values [S, n, lanes]")
    s_n, n = keys.shape
    lanes = values.shape[2]
    cap = n_buckets * ways
    tk, tv, ek, ev = _launch(
        keys.reshape(s_n * n), values.reshape(s_n * n, lanes),
        n_buckets=n_buckets, ways=ways, op=op,
        table_keys=(None if table_keys is None
                    else table_keys.reshape(s_n * cap)),
        table_values=(None if table_values is None
                      else table_values.reshape(s_n * cap, lanes)),
        n_tables=max(1, s_n))
    table_launches += 1
    return (tk.reshape(s_n, cap), tv.reshape(s_n, cap, lanes),
            ek.reshape(s_n, n), ev.reshape(s_n, n, lanes))


def fpe_aggregate_cuda(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int = 4,
    op: str = "sum",
    exact_stream: bool = True,
):
    """Run the FPE kernel over a KV stream — the ``fpe_aggregate_pallas``
    contract.

    Returns ``kvagg.FPEResult``: table [cap] / [cap, *lanes], eviction
    stream [n] / [n, *lanes].  ``exact_stream=False`` pre-combines the
    stream to distinct keys (``kvagg.sorted_combine``, fixed shape [n])
    before the exact scan: the resident table equals ``kvagg``'s fast
    path, the eviction stream stays [n].
    """
    if not exact_stream:
        c = _kvagg.sorted_combine(keys, values, op=op)
        keys, values = c.unique_keys, c.combined_values
    return _kvagg.fpe_aggregate(keys, values, capacity=capacity, ways=ways,
                                op=op, exact_stream=True)
