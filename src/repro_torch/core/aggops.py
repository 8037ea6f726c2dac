"""AggOp registry — the single source of truth for aggregation-operator
semantics (DESIGN.md §6), ported to torch.

Counterpart of ``repro/core/aggops.py``: the same six ops (sum, max, min,
count, mean with paired (sum, count) lanes, logsumexp), the same shared
key hash, and the same dtype-aware identities.  Every aggregation path of
the port — the plain FPE scan and BPE sorted combine (``core.kvagg``),
the CUDA FPE kernel (``kernels.kv_aggregate``, which mirrors ``combine``
in C++ per op) and the cascade executor (``core.dataplane``) — resolves
its op HERE.

An :class:`AggOp` carries:

  * ``combine(a, b)``     — the elementwise merge of two values of a key.
  * ``identity(dtype)``   — the dtype-aware neutral element: max/min use
                            ``finfo``/``iinfo`` bounds, never ±inf
                            (logsumexp's identity IS -inf).
  * ``lanes``             — carried value lanes (``mean`` carries 2).
  * ``prepare(values)``   — user values -> carried representation.
  * ``finalize(values)``  — carried representation -> user result.
  * ``segment_reduce``    — the bulk (BPE) form of ``combine``: sums in
                            ascending index order (``index_add_`` on the
                            CPU, the in-order segmented-sum kernel on a
                            card), ``scatter_reduce_`` with ``amax``/
                            ``amin`` for max/min.  Ids outside
                            [0, num_segments) are dropped, as JAX drops
                            them; ``ids_grouped=True`` says each id's
                            entries are one contiguous run.

Associativity + commutativity of ``combine`` is the contract every op
honors — it is what makes multi-level cascades exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import segment_sum as _segsum

# ---------------------------------------------------------------------------
# Shared key hash.
# ---------------------------------------------------------------------------

#: Knuth/Fibonacci multiplicative hash constant — the same constant as the
#: JAX package and ``kernels/csrc/fpe_aggregate.cu`` (``fpe_hash``).
HASH_MULT = 0x9E3779B1
_U32 = 0xFFFFFFFF


def hash_key(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative hash of int32 keys into [0, n_buckets), bit for bit
    the JAX package's uint32 hash.

    torch's ``uint32`` supports few operations, so the arithmetic runs in
    int64 masked to 32 bits: the int64 product may wrap, but wrapping
    modulo 2**64 keeps the low 32 bits exact.
    """
    h = ((key.to(torch.int64) & _U32) * HASH_MULT) & _U32
    h = h ^ (h >> 15)
    return (h % n_buckets).to(torch.int32)


def hash_key_int(key: int, n_buckets: int) -> int:
    """:func:`hash_key` of one Python int (the plain scan's per-pair hash)."""
    h = ((key & _U32) * HASH_MULT) & _U32
    h ^= h >> 15
    return h % n_buckets


def _bound_identity(dtype: torch.dtype, kind: str) -> float | int:
    """Dtype-aware max/min identity: finfo/iinfo bounds, never ±inf."""
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
    elif dtype in (torch.int8, torch.int16, torch.int32, torch.int64,
                   torch.uint8):
        info = torch.iinfo(dtype)
    else:
        raise TypeError(f"unsupported value dtype for max/min: {dtype}")
    return info.min if kind == "max" else info.max


def _as_float(values: torch.Tensor) -> torch.Tensor:
    """Carried dtype for ops whose algebra needs a field (mean, logsumexp)."""
    if values.dtype.is_floating_point:
        return values
    return values.to(torch.float32)


def _segment_init(shape, dtype, device, kind: str) -> torch.Tensor:
    """Start value of an unsorted segment max/min: what
    ``jax.ops.segment_max``/``segment_min`` leave in an empty segment
    (-inf/+inf for floats, the iinfo bound for integers)."""
    if dtype.is_floating_point:
        fill = float("-inf") if kind == "max" else float("inf")
    else:
        fill = _bound_identity(dtype, kind)
    return torch.full(shape, fill, dtype=dtype, device=device)


def _segment_sum(values, segment_ids, num_segments, *, ids_grouped=False):
    """Segment sum that adds each segment's values in ascending index
    order, one rounding per add, as ``jax.ops.segment_sum`` does on the
    CPU: ``index_add_`` lane by lane on a CPU tensor (the 1-D form adds in
    index order; the 2-D form of a bf16 tensor does not), the in-order
    segmented-sum kernel on a CUDA tensor, where ``index_add_`` would add
    with atomics in no fixed order (``kernels.segment_sum``).
    """
    return _segsum.segment_sum(values, segment_ids, num_segments,
                               ids_grouped=ids_grouped)


def _segment_extreme(kind: str):
    reduce = "amax" if kind == "max" else "amin"

    def seg(values, segment_ids, num_segments, *, ids_grouped=False):
        """Ids outside [0, num_segments) are dropped (reduced into a spare
        segment past the last).  max and min do not depend on the order:
        ``ids_grouped`` is unused."""
        shape = (num_segments + 1,) + tuple(values.shape[1:])
        out = _segment_init(shape, values.dtype, values.device, kind)
        ids = segment_ids.to(torch.int64)
        ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                          num_segments)
        idx = ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
        return out.scatter_reduce_(0, idx, values, reduce,
                                   include_self=False)[:num_segments]

    return seg


_segment_max = _segment_extreme("max")
_segment_min = _segment_extreme("min")


@dataclasses.dataclass(frozen=True)
class AggOp:
    """One registered aggregation operator; see the module docstring."""

    name: str
    combine: Callable  # (a, b) -> merged, elementwise per carried lane
    identity: Callable  # (dtype, device=None) -> 0-d neutral element
    # (values, segment_ids, num_segments, *, ids_grouped=False) -> [S, ...]
    segment_reduce: Callable
    lanes: int = 1
    prepare: Callable | None = None  # user values -> carried values
    finalize: Callable | None = None  # carried values -> user values

    def prepare_values(self, values: torch.Tensor) -> torch.Tensor:
        """Map raw values [n] to the carried representation ([n] or
        [n, lanes]); a registration whose ``lanes`` and ``prepare``
        disagree fails loudly."""
        out = values if self.prepare is None else self.prepare(values)
        want = tuple(values.shape[:1]) + (
            (self.lanes,) if self.lanes > 1 else ())
        if tuple(out.shape) != want:
            raise ValueError(
                f"op {self.name!r} declares lanes={self.lanes} but prepare "
                f"produced shape {tuple(out.shape)} (expected {want})")
        return out

    def finalize_values(self, values: torch.Tensor) -> torch.Tensor:
        """Collapse the carried representation back to user values."""
        return values if self.finalize is None else self.finalize(values)


_REGISTRY: dict[str, AggOp] = {}


def register(op: AggOp) -> AggOp:
    """Add an op to the registry (last registration wins)."""
    _REGISTRY[op.name] = op
    return op


def get(name: str) -> AggOp:
    """Resolve an op by name; raises ValueError listing what IS registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unsupported aggregation op: {name!r} (registered: {names()})"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Registered ops.
# ---------------------------------------------------------------------------


def _f32_transcendental(fn):
    """``fn`` in the value dtype, computed in f64 and rounded to f32 first
    (bf16 then rounds once more, as a bf16 op computed in f32 does).

    The f64 result is within one f64 ulp of exact on the CPU and on the
    card, so its f32 rounding is the correctly rounded f32 value on both:
    the FPE kernel computes the same and agrees with this bit for bit, and
    the BPE's logsumexp gives the same bits on either device.
    """
    def op(x):
        if x.dtype == torch.float64:
            return fn(x)
        return fn(x.double()).float().to(x.dtype)
    return op


_exp = _f32_transcendental(torch.exp)
_log1p = _f32_transcendental(torch.log1p)
_log = _f32_transcendental(torch.log)


def _segment_logsumexp(values, segment_ids, num_segments, *,
                       ids_grouped=False):
    """Numerically stable segmented logsumexp (two-pass max-shift)."""
    seg = segment_ids.to(torch.int64)
    m = _segment_max(values, seg, num_segments)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = _segment_sum(_exp(values - m_safe[seg]), seg, num_segments,
                     ids_grouped=ids_grouped)
    out = m_safe + _log(s)
    return torch.where(s > 0, out, torch.full_like(out, float("-inf")))


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp`` op by op, every op rounding to the value dtype:
    ``max(a, b) + log1p(exp(-|a - b|))``, or ``a + b`` where ``a - b`` is
    NaN (a NaN input, or infinities of the same sign).

    ``torch.logaddexp`` instead computes a bf16 input in f32 and rounds
    once.  The one remaining difference from the JAX package is the f32
    exp and log1p (XLA's approximations vs correctly rounded ones here).
    ``kernels/csrc/fpe_aggregate.cu`` (``combine<kLogSumExp>``) repeats
    these steps.
    """
    amax = torch.maximum(a, b)
    delta = a - b
    out = amax + _log1p(_exp(-delta.abs()))
    return torch.where(torch.isnan(delta), a + b, out)


def _mean_prepare(values: torch.Tensor) -> torch.Tensor:
    v = _as_float(values)
    return torch.stack([v, torch.ones_like(v)], dim=-1)


def _mean_finalize(carried: torch.Tensor) -> torch.Tensor:
    total, count = carried[..., 0], carried[..., 1]
    safe = torch.where(count != 0, count, torch.ones_like(count))
    return torch.where(count != 0, total / safe, torch.zeros_like(total))


def _const(value_of):
    """identity(dtype, device=None) -> 0-d tensor of ``value_of(dtype)``."""
    def identity(dtype, device=None):
        return torch.tensor(value_of(dtype), dtype=dtype, device=device)
    return identity


SUM = register(AggOp(
    name="sum",
    combine=lambda a, b: a + b,
    identity=_const(lambda dtype: 0),
    segment_reduce=_segment_sum,
))

MAX = register(AggOp(
    name="max",
    combine=torch.maximum,
    identity=_const(lambda dtype: _bound_identity(dtype, "max")),
    segment_reduce=_segment_max,
))

MIN = register(AggOp(
    name="min",
    combine=torch.minimum,
    identity=_const(lambda dtype: _bound_identity(dtype, "min")),
    segment_reduce=_segment_min,
))

COUNT = register(AggOp(
    name="count",
    combine=lambda a, b: a + b,
    identity=_const(lambda dtype: 0),
    segment_reduce=_segment_sum,
    # every record carries weight 1; the values' own payload is irrelevant
    prepare=lambda values: torch.ones(values.shape[:1], dtype=torch.int32,
                                      device=values.device),
))

MEAN = register(AggOp(
    name="mean",
    combine=lambda a, b: a + b,  # (sum, count) lanes both merge by add
    identity=_const(lambda dtype: 0),
    segment_reduce=_segment_sum,
    lanes=2,
    prepare=_mean_prepare,
    finalize=_mean_finalize,
))

LOGSUMEXP = register(AggOp(
    name="logsumexp",
    combine=logaddexp,
    # -inf IS the logaddexp identity; integer inputs are lifted to f32 by
    # prepare, so no iinfo case arises
    identity=_const(lambda dtype: float("-inf")),
    segment_reduce=_segment_logsumexp,
    prepare=_as_float,
))
