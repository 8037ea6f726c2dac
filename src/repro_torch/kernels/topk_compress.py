"""Per-row magnitude top-k on Hopper (the KV payload producer): CUDA C++
kernel wrapper.

Port of the Pallas TPU kernel ``_topk_kernel`` / ``topk_rows_pallas``
(``src/repro/kernels/topk_compress.py:29`` and ``:47``).  What it
computes: per row, the k columns of largest ``|x|`` (in f32), descending,
ties to the LOWEST column, NaN above +inf; the signed values in
``x.dtype`` and the int32 column indices.  A magnitude below the
smallest normal f32 (a denormal) ranks as 0, as XLA, which flushes
denormals to zero, ranks it in the JAX package (``kernels.ref.topk_ref``);
the value returned keeps its bits, as ``topk_ref``'s gather keeps them.

The kernel is ``csrc/topk_rows.cu``: one block per row reads the row
once, finds the k-th largest magnitude by a radix select over the bit
patterns of ``|x|`` (four 8-bit digit histograms in shared memory), keeps
every column above it and the lowest-column ties at it (an ordered,
ballot-ranked compaction), and sorts the k candidates.  What bounds it:
reading ``rows * cols * bytes`` once.  :func:`topk_rows_radix_plain` is
the plain model of that algorithm, on no path: the tests hold it against
the plain version.

Dispatch rule (no fallbacks): a CPU tensor takes :func:`topk_rows_plain`
(a stable descending sort on ``|x|``, which keeps ties at the lower
index); a CUDA tensor launches the kernel or raises.  ``launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches in this process (set to 0 to start a count)
launches = 0

#: value dtype -> the kernel's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the key of every NaN: above +inf's bit pattern
NAN_KEY = 0xFFFFFFFF
#: the bits of the smallest normal f32; a magnitude below it ranks as 0
FLT_MIN_BITS = 0x00800000


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("topk_rows")
    if lib.topk_rows_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_rows_launch.argtypes = [p, i, i, i, i, p, p, p]
        lib.topk_rows_launch.restype = i
    return lib


def topk_rows_plain(x: torch.Tensor, k: int):
    """Plain torch top-k by |.| per row: (values [rows, k] in x.dtype,
    indices [rows, k] int32), descending, ties to the lower index,
    denormal magnitudes ranked as 0."""
    rows, cols = x.shape
    if k > cols:
        raise ValueError(f"k={k} > cols={cols}")
    mag = x.to(torch.float32).abs()
    mag = torch.where(mag < torch.finfo(torch.float32).tiny, 0.0, mag)
    idx = torch.sort(mag, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def magnitude_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ordering key of each element: the bit pattern of
    ``|x|`` in f32 as a non-negative int64, every NaN ``NAN_KEY``, every
    denormal 0."""
    u = x.to(torch.float32).abs().view(torch.int32).to(torch.int64)
    u = torch.where(u < FLT_MIN_BITS, 0, u)
    return torch.where(u > 0x7F800000, NAN_KEY, u)


def topk_rows_radix_plain(x: torch.Tensor, k: int):
    """Plain model of the kernel's algorithm (CPU tensors; tests only):
    radix select of the k-th largest key, 8 bits a pass from the top,
    then the keys above it and the lowest-column ties at it, sorted by
    (key descending, column ascending).  Returns what
    :func:`topk_rows_plain` returns, and must equal it bit for bit."""
    rows, cols = x.shape
    if k > cols:
        raise ValueError(f"k={k} > cols={cols}")
    keys = magnitude_keys(x)
    idx = torch.empty((rows, k), dtype=torch.int64)
    for r in range(rows):
        key = keys[r]
        prefix, mask, rank = 0, 0, k
        for shift in (24, 16, 8, 0):
            match = (key & mask) == prefix
            hist = torch.bincount((key[match] >> shift) & 0xFF,
                                  minlength=256)
            above = 0
            for d in range(255, -1, -1):  # the digit holding the rank
                if above + int(hist[d]) >= rank:
                    break
                above += int(hist[d])
            prefix |= d << shift
            mask |= 0xFF << shift
            rank -= above
        gt = torch.nonzero(key > prefix).flatten()
        ties = torch.nonzero(key == prefix).flatten()[:rank]  # column order
        cand = torch.cat([gt, ties])
        order = sorted(cand.tolist(), key=lambda c: (-int(key[c]), c))
        idx[r] = torch.tensor(order, dtype=torch.int64)
    # gather copies the bits of each value, NaN payloads included
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def topk_rows(x: torch.Tensor, *, k: int):
    """Top-k by |.| per row of x [rows, cols] -> (values, indices) [rows, k].

    CPU tensors take :func:`topk_rows_plain`; CUDA tensors launch the
    kernel.  ``k > cols`` raises ``ValueError`` on both.
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
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows and k:
        with _build.on_device(x.device):
            rc = _lib().topk_rows_launch(
                x.data_ptr(), rows, cols, k, DTYPE_CODES[x.dtype],
                vals.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:  # a row too wide for shared memory is refused here
            raise RuntimeError(f"top-k kernel launch failed: cudaError {rc}")
        launches += 1
    return vals, idx
