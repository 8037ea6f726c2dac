"""Plain torch oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``).

Each kernel has an exact reference here, run on the CPU by the tests and
beside the kernel on the card by ``chip_smoke.py``.  Op semantics are not
defined here: ``repro_torch.core.aggops`` is the one source (DESIGN.md
§6).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import aggops
from repro_torch.core import kvagg as _kvagg

from .topk_compress import topk_rows_plain

EMPTY_KEY = _kvagg.EMPTY_KEY


def fpe_aggregate_ref(keys, values, *, capacity: int, ways: int = 4,
                      op: str = "sum", table_keys=None, table_values=None):
    """Oracle for the FPE kernel: the plain sequential scan (CPU tensors).

    Returns ``kvagg.FPEResult`` with the scan's [n] eviction stream.
    """
    n = keys.shape[0]
    ways, n_buckets, cap = _kvagg._fpe_geometry(capacity, ways)
    lane_shape = tuple(values.shape[1:])
    lanes = math.prod(lane_shape)
    tk, tv, ek, ev = _kvagg._fpe_scan_plain(
        keys, values.reshape(n, lanes), n_buckets=n_buckets, ways=ways,
        op=op, table_keys=table_keys,
        table_values=(None if table_values is None
                      else table_values.reshape(cap, lanes)))
    return _kvagg.FPEResult(tk, tv.reshape((cap,) + lane_shape), ek,
                            ev.reshape((n,) + lane_shape))


def sorted_combine_ref(keys, values, *, op: str = "sum"):
    return _kvagg.sorted_combine(keys, values, op=op)


def topk_ref(x: torch.Tensor, k: int):
    """Oracle for the per-row magnitude top-k kernel: (values [rows, k],
    indices [rows, k] int32), descending |.|, ties to the lower index."""
    return topk_rows_plain(x, k)


def segment_sum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int):
    return aggops.get("sum").segment_reduce(values, segment_ids, num_segments)
