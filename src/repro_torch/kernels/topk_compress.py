"""Per-row magnitude top-k on Hopper (the KV payload producer): Triton.

Port of the Pallas TPU kernel ``_topk_kernel`` / ``topk_rows_pallas``
(``src/repro/kernels/topk_compress.py:29`` and ``:47``).  What it
computes: k argmax sweeps over ``|x|`` in f32 per row; each sweep takes
the largest remaining magnitude, the LOWEST column that holds it (ties to
the lower index), and masks that column to -inf.  It returns the signed
values in ``x.dtype`` and the int32 column indices, in descending
magnitude.

Design: one Triton program per row holds the whole ``cols``-wide row in
registers (``BLOCK_COLS``, a power-of-two ``tl.constexpr``; a ragged
width is masked), so the row is read from device memory once and the k
sweeps are two register reductions each (``tl.max``, then ``tl.min`` of
the matching column indices).  What bounds it on this card: reading
``rows * cols * bytes`` once — about 30 us for the 100 MB gradient
matrix at 3.35 TB/s — with k small (~1% of cols) the sweeps should stay
under that; the per-sweep cross-warp reductions are what a later PR
would tune.

Dispatch rule (no fallbacks): a CPU tensor takes :func:`topk_rows_plain`
(a stable descending sort on ``|x|``, which keeps ties at the lower
index); a CUDA tensor launches the kernel or raises.  ``launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: kernel launches in this process (set to 0 to start a count)
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def topk_rows_plain(x: torch.Tensor, k: int):
    """Plain torch top-k by |.| per row: (values [rows, k] in x.dtype,
    indices [rows, k] int32), descending, ties to the lower index."""
    rows, cols = x.shape
    if k > cols:
        raise ValueError(f"k={k} > cols={cols}")
    mag = x.to(torch.float32).abs()
    idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(x, 1, idx), idx.to(torch.int32)


@functools.cache
def _kernel():
    _build.triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def topk_rows_kernel(x_ptr, vals_ptr, idx_ptr, cols, stride_row,
                         K: tl.constexpr, BLOCK_COLS: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        offs = tl.arange(0, BLOCK_COLS)
        inb = offs < cols
        x = tl.load(x_ptr + row * stride_row + offs, mask=inb, other=0.0)
        x32 = x.to(tl.float32)
        mag = tl.where(inb, tl.abs(x32), float("-inf"))
        for j in range(K):
            m = tl.max(mag, axis=0)
            am = tl.min(tl.where(mag == m, offs, BLOCK_COLS), axis=0)
            hit = offs == am
            v = tl.max(tl.where(hit, x32, float("-inf")), axis=0)
            tl.store(vals_ptr + row * K + j, v.to(vals_ptr.dtype.element_ty))
            tl.store(idx_ptr + row * K + j, am.to(tl.int32))
            mag = tl.where(hit, float("-inf"), mag)

    return triton, topk_rows_kernel


def topk_rows(x: torch.Tensor, *, k: int):
    """Top-k by |.| per row of x [rows, cols] -> (values, indices) [rows, k].

    CPU tensors take :func:`topk_rows_plain`; CUDA tensors launch the
    Triton kernel.  ``k > cols`` raises ``ValueError`` on both.
    """
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, cols], got shape {tuple(x.shape)}")
    rows, cols = x.shape
    if k > cols:
        raise ValueError(f"k={k} > cols={cols}")
    if x.device.type == "cpu":
        return topk_rows_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"the top-k kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows:
        triton, kern = _kernel()
        block = max(16, triton.next_power_of_2(cols))
        with torch.cuda.device(x.device):
            kern[(rows,)](x, vals, idx, cols, x.stride(0), K=k,
                          BLOCK_COLS=block,
                          num_warps=8 if block >= 2048 else 4)
        launches += 1
    return vals, idx
