"""Public wrappers over the port's kernels (counterpart of
``repro/kernels/ops.py``).

``two_level_aggregate`` is the full SwitchAgg node: the FPE kernel
(hash table, evict-on-collision) feeding the BPE bulk combine over the
eviction stream; node accounting is ``kvagg.assemble_node``.
``compress_grad`` is the gradient -> KV payload producer on the top-k
kernel, with error feedback.  Multi-level plans run via
``core.dataplane.run_cascade(backend="cuda")``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kvagg as _kvagg

from .kv_aggregate import fpe_aggregate_cuda
from .topk_compress import topk_rows

EMPTY_KEY = _kvagg.EMPTY_KEY


class TwoLevelOut(NamedTuple):
    out_keys: torch.Tensor
    out_values: torch.Tensor
    n_out: torch.Tensor
    n_in: torch.Tensor
    n_evict: torch.Tensor


def two_level_aggregate(
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    capacity: int,
    ways: int = 4,
    op: str = "sum",
    bpe: bool = True,
    exact_stream: bool = True,
) -> TwoLevelOut:
    """SwitchAgg node with the FPE kernel + BPE bulk combine.

    ``exact_stream=False`` pre-combines the stream before the kernel
    (DESIGN.md §8 fast path): identical grouped output, different
    eviction pattern.
    """
    tk, tv, ek, ev = fpe_aggregate_cuda(keys, values, capacity=capacity,
                                        ways=ways, op=op,
                                        exact_stream=exact_stream)
    return TwoLevelOut(*_kvagg.assemble_node(keys, tk, tv, ek, ev,
                                             op=op, bpe=bpe))


def compress_grad(grad: torch.Tensor, residual: torch.Tensor, *, k: int,
                  chunk: int = 4096):
    """Blockwise top-k gradient -> KV payload on the top-k kernel.

    Returns (keys [rows*k] int32 global flat indices ``idx + row*chunk``,
    values [rows*k], new_residual) with error feedback: the residual is
    ``grad + residual`` zeroed at the chosen keys.  ``chunk`` is the
    per-FPE-group working set (cols per row).
    """
    acc = grad.to(residual.dtype).reshape(-1) + residual.reshape(-1)
    n = acc.shape[0]
    if n % chunk != 0:
        raise ValueError(f"grad size {n} not divisible by chunk {chunk}")
    mat = acc.reshape(-1, chunk)
    vals, idx = topk_rows(mat, k=k)
    rows = mat.shape[0]
    row_base = torch.arange(rows, dtype=torch.int32, device=acc.device)
    gkeys = (idx + row_base[:, None] * chunk).reshape(-1)
    # acc is this call's own buffer, so the residual is zeroed in place
    new_res = acc.index_fill_(0, gkeys.to(torch.int64), 0.0)
    return gkeys, vals.reshape(-1), new_res.reshape(residual.shape)
