"""Gradient -> KV-pair compression (the SwitchAgg payload producer), ported
to torch (counterpart of ``repro/core/compressor.py``).

    key   = flat index of a retained gradient coordinate
    value = the gradient value at that coordinate

Error feedback (memory of the unsent residual) keeps the compression
unbiased over time.  These functions are plain torch, as the JAX ones are
plain jnp; the kernel path for the gradient is ``kernels.ops.compress_grad``.
``jax.lax.top_k`` puts ties at the lower index and ``torch.topk``
promises no order, so selection is a stable descending sort on ``|x|``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aggops


class CompressedGrad(NamedTuple):
    keys: torch.Tensor  # [k] int32 flat indices
    values: torch.Tensor  # [k] float
    shape: tuple  # original shape


class CompressorState(NamedTuple):
    residual: torch.Tensor  # error-feedback memory, same shape as grad


def init_state(shape, dtype=torch.float32, *,
               device: str | torch.device = "cuda") -> CompressorState:
    """Zero residual of ``shape`` on ``device`` (raises without a card
    unless ``device="cpu"``)."""
    return CompressorState(residual=torch.zeros(
        tuple(shape), dtype=dtype, device=resolve_device(device)))


def _topk_desc(mag: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices[..., :k]


def topk_compress(grad: torch.Tensor, state: CompressorState, *, k: int
                  ) -> tuple[CompressedGrad, CompressorState]:
    """Select the k largest-|.| coordinates of (grad + residual)."""
    acc = grad.to(state.residual.dtype) + state.residual
    flat = acc.reshape(-1)
    idx = _topk_desc(flat.abs(), k)
    picked = flat[idx]
    new_res = flat.clone().index_fill_(0, idx, 0.0).reshape(acc.shape)
    return (CompressedGrad(idx.to(torch.int32), picked, tuple(grad.shape)),
            CompressorState(residual=new_res))


def decompress_sum(keys: torch.Tensor, values: torch.Tensor, *,
                   size: int) -> torch.Tensor:
    """Scatter-add a KV stream back to a dense flat vector of ``size``.

    Keys below 0 (EMPTY) are dropped; duplicate keys accumulate, so a
    partially combined stream still decompresses to the exact sum.  Each
    slot adds its duplicates in stream order, on the CPU and on a card
    (``aggops``' in-order segment sum).
    """
    valid = keys >= 0
    safe = torch.where(valid, keys, 0).to(torch.int64)
    contrib = torch.where(valid, values, torch.zeros_like(values))
    return aggops.get("sum").segment_reduce(contrib, safe, size)


def blockwise_topk_compress(grad: torch.Tensor, state: CompressorState, *,
                            k: int, chunk: int
                            ) -> tuple[CompressedGrad, CompressorState]:
    """Top-k per contiguous chunk — bounded working set per FPE group
    (the payload analyzer's one engine per group)."""
    acc = grad.to(state.residual.dtype) + state.residual
    flat = acc.reshape(-1)
    n = flat.shape[0]
    if n % chunk != 0:
        raise ValueError(f"size {n} not divisible by chunk {chunk}")
    rows = n // chunk
    mat = flat.reshape(rows, chunk)
    idx = _topk_desc(mat.abs(), k)  # [rows, k]
    picked = torch.gather(mat, 1, idx)
    gkeys = (idx + torch.arange(rows, device=flat.device)[:, None] * chunk
             ).reshape(-1)
    new_flat = flat.clone().index_fill_(0, gkeys, 0.0)
    return (CompressedGrad(gkeys.to(torch.int32), picked.reshape(-1),
                           tuple(grad.shape)),
            CompressorState(residual=new_flat.reshape(acc.shape)))


def compression_ratio(shape, k_total: int, key_bytes: int = 4,
                      val_bytes: int = 4, dense_bytes: int = 4) -> float:
    """Payload bytes of the KV stream vs the dense gradient."""
    dense = float(np.prod(shape)) * dense_bytes
    kv = float(k_total) * (key_bytes + val_bytes)
    return kv / dense
