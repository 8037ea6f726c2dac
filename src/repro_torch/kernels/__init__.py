"""Hand-written Hopper kernels of the port (counterpart of ``repro.kernels``).

  kv_aggregate   — the FPE hash-combine engine, CUDA C++ (csrc/fpe_aggregate.cu)
  topk_compress  — per-row magnitude top-k, CUDA C++ (csrc/topk_rows.cu)
  segment_sum    — the BPE's in-order segmented sum, CUDA C++
                   (csrc/segment_sum.cu)
  ops            — the public wrappers (two_level_aggregate, compress_grad)
  ref            — the plain torch oracles

Every wrapper takes its kernel's plain torch version for a CPU tensor and
launches the kernel (or raises) for a CUDA tensor.  Kernels are built on
first use, never at import time.
"""
