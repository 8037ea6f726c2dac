"""In-order segmented sum on Hopper: CUDA C++ kernel wrapper (the BPE's
sum on a card).

``index_add_`` on a CUDA tensor adds with atomics in no fixed order, so
the BPE's f32 sums on the card would differ from the CPU's (and the JAX
package's ``jax.ops.segment_sum``) in the last bits.  The kernel,
``csrc/segment_sum.cu``, adds each segment in ascending index order with
one rounding per add; its source note says how.  It replaces no TPU
kernel.

Dispatch rule (no fallbacks): a CPU tensor takes :func:`segment_sum_plain`
(``index_add_`` one lane at a time, which adds in index order); a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: value dtype -> the kernel's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
               torch.float16: 3, torch.float64: 4, torch.int64: 5}

#: kernel launches in this process (set to 0 to start a count)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("segment_sum")
    if lib.segment_sum_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.segment_sum_launch.argtypes = [p, p, i64, i, i64, i, p, p]
        lib.segment_sum_launch.restype = i
    return lib


def segment_sum_plain(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain version: ``index_add_`` lane by lane on CPU tensors.  Ids
    outside [0, num_segments) are dropped (they add into a spare segment
    past the last), as ``jax.ops.segment_sum`` drops them."""
    if values.device.type != "cpu" or segment_ids.device.type != "cpu":
        raise ValueError("the plain segment sum serves only CPU tensors")
    seg = segment_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    flat = values.reshape(values.shape[0], -1)
    cols = [torch.zeros((num_segments + 1,), dtype=values.dtype).index_add_(
        0, seg, flat[:, l].contiguous())[:num_segments]
        for l in range(flat.shape[1])]
    return torch.stack(cols, dim=-1).reshape(
        (num_segments,) + tuple(values.shape[1:]))


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, ids_grouped: bool = False
                ) -> torch.Tensor:
    """out[s] = the sum of ``values[i]`` over ``segment_ids[i] == s``, in
    ascending i; ids outside [0, num_segments) are dropped.  values
    [n, ...], segment_ids [n]; ``ids_grouped`` says that the entries of
    each id are one contiguous run (else a stable sort groups them first).
    """
    global launches
    if values.device.type == "cpu":
        return segment_sum_plain(values, segment_ids, num_segments)
    dev = values.device
    if dev.type != "cuda" or segment_ids.device != dev:
        raise ValueError(f"the segment-sum kernel needs CUDA tensors, got "
                         f"{dev} and {segment_ids.device}")
    if values.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {values.dtype}")
    n = values.shape[0]
    if tuple(segment_ids.shape) != (n,):
        raise ValueError(f"segment_ids has shape {tuple(segment_ids.shape)},"
                         f" expected ({n},)")
    lane_shape = tuple(values.shape[1:])
    flat = values.reshape(n, -1)
    lanes = flat.shape[1]
    out = torch.zeros((num_segments, lanes), dtype=values.dtype, device=dev)
    ids = segment_ids.to(torch.int64)
    if not ids_grouped:
        ids, perm = torch.sort(ids, stable=True)
        flat = flat[perm]
    flat, ids = flat.contiguous(), ids.contiguous()
    if n and lanes:
        with _build.on_device(dev):
            rc = _lib().segment_sum_launch(
                flat.data_ptr(), ids.data_ptr(), n, lanes, num_segments,
                DTYPE_CODES[values.dtype], out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"segment-sum kernel launch failed: "
                               f"cudaError {rc}")
        launches += 1
    return out.reshape((num_segments,) + lane_shape)
