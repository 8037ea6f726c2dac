#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Needs one NVIDIA GPU (written for an H100).  It builds the port's two
kernels from this checkout -- the FPE hash-combine engine with nvcc
(``kernels/csrc/fpe_aggregate.cu``) and the per-row top-k with Triton
(``kernels/topk_compress.py``) -- holds each against its plain torch
version, then drives the slice's main path through the entry points a
user calls:

  wordcount      the paper's MapReduce word count: 8 x 1 M Zipf-0.99
                 pairs through a 2-level ``run_cascade(backend="cuda")``;
  grad_exchange  8 workers' phi4-mini MLP gradients (8192 x 3072) through
                 ``kernels.ops.compress_grad``, a 2-level sum cascade and
                 ``compressor.decompress_sum``;
  stream         ``run_cascade_stream`` over 59-record packets, the FPE
                 kernel resumed from the resident table on every ingest.

Each phase prints one JSON line; any mismatch raises (non-zero exit, no
result line).  The kernel launch counters are set to 0 just before each
main-path phase and read just after it.  The line before the last is the
per-kernel summary ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import aggops, compressor, dataplane, kvagg  # noqa: E402
from repro_torch.core import reduction_model as rm  # noqa: E402
from repro_torch.core.dataplane import CascadePlan, LevelSpec  # noqa: E402
from repro_torch.kernels import _build, kv_aggregate, ops  # noqa: E402
from repro_torch.kernels import topk_compress  # noqa: E402
from repro_torch.net import wire  # noqa: E402

EMPTY = kvagg.EMPTY_KEY
#: H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: logsumexp's tolerance: the card's expf/log1pf are not the CPU's, so
#: |kernel - plain| <= tol * max(1, |plain|).  f32: 1e-6.  bf16 combines
#: in f32 and rounds once, so a last-bit f32 difference can round to the
#: neighbouring bf16 value: one bf16 ulp, 2**-7.
LSE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def counted(fn):
    """Run ``fn`` with both launch counters set to 0; return its result
    and the launches it made."""
    kv_aggregate.launches = 0
    topk_compress.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"fpe_aggregate": kv_aggregate.launches,
                 "topk_rows": topk_compress.launches}


def cuda_ms(fn, iters: int = 10, warmup: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once, and its time in ms on the card's
    clock (events around the call, then a synchronize)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn(*args, **kwargs)
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work on an H100: bytes over HBM bandwidth vs
    operations over the f32 rate; the larger one and its name."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a value tensor, for bit-identity checks."""
    t = t.contiguous()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


# ---------------------------------------------------------------------------
# 1. device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: chip_smoke.py "
                         "needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # one nvcc for the CUDA source, started beside the Triton JIT
    errors: list[BaseException] = []

    def build_fpe():
        try:
            kv_aggregate._lib()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    th = threading.Thread(target=build_fpe)
    th.start()
    x = torch.randn((8, 4096), device="cuda")
    topk_compress.topk_rows(x, k=41)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    th.join()
    if errors:
        raise errors[0]
    info = {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit("device", **info,
         fpe_so_build_s=_build.build_seconds.get("fpe_aggregate", 0.0),
         triton_first_call_s=triton_s,
         build_total_s=time.perf_counter() - t0)
    return info


# ---------------------------------------------------------------------------
# 2. FPE kernel vs its plain scan
# ---------------------------------------------------------------------------

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
#: CUDA's default dynamic shared memory per block; a larger table needs
#: the cudaFuncSetAttribute opt-in
SMEM_DEFAULT = 48 * 1024
FPE_SWEEP = (("sum", (F32, BF16, I32)), ("max", (F32, BF16, I32)),
             ("min", (F32, BF16, I32)), ("count", (I32,)),
             ("mean", (F32, BF16)), ("logsumexp", (F32, BF16)))
#: (capacity, ways); 16384 x 4 is the main path's level table, past the
#: 48 KB default shared-memory limit (the kernel's opt-in launch)
FPE_GEOMETRIES = ((64, 1), (1024, 4), (4096, 8), (2048, 64), (16384, 4))


def table_bytes(n_buckets: int, ways: int, lanes: int, dtype) -> int:
    """The kernel's table size (fpe_aggregate.cu ``table_bytes``): keys
    padded to 16 bytes, then the values."""
    cap = n_buckets * ways
    elem = 2 if dtype == BF16 else 4
    return (cap * 4 + 15) // 16 * 16 + cap * lanes * elem


def _fpe_stream(rng, n: int, variety: int, op: str, dtype, seed: int):
    """Zipf-0.99 keys with 5% EMPTY pads and the op's carried values
    ([n, lanes] CPU tensors)."""
    keys = rm.zipf_keys(n, variety, seed=seed).astype(np.int32)
    keys[rng.random(n) < 0.05] = EMPTY
    if dtype == I32:
        raw = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int32))
    else:
        raw = torch.from_numpy(
            (rng.standard_normal(n) * 4).astype(np.float32)).to(dtype)
    vals = aggops.get(op).prepare_values(raw)
    return torch.from_numpy(keys), vals.reshape(n, -1).contiguous()


def _fpe_compare(label: str, op: str, got, want) -> float:
    """Raise unless the kernel's (table, evictions) equal the plain scan's:
    keys exactly, values bit for bit (logsumexp within LSE_TOL).  Returns
    the largest absolute value difference."""
    names = ("table_keys", "table_values", "evict_keys", "evict_values")
    err = 0.0
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label} {name}: {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        d = (g.double() - w.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if op == "logsumexp" and name.endswith("values"):
            tol = LSE_TOL[w.dtype] * w.double().abs().clamp(min=1)
            check(bool((d <= tol).all()), f"{label} {name} off by {err}")
        else:
            check(torch.equal(bits(g), bits(w)), f"{label} {name} differ")
    return err


def phase_fpe_kernel_vs_plain(seed: int) -> float:
    rng = np.random.default_rng(seed)
    n, variety = 8192, 16384
    cases, n_opt_in, max_err = 0, 0, 0.0
    t0 = time.perf_counter()

    def run_case(op, dtype, capacity, ways, keys, vals, resume):
        ways, nb, cap = kvagg._fpe_geometry(capacity, ways)
        tk0 = tv0 = None
        if resume:  # a resident table from an earlier stream
            rk, rv = _fpe_stream(rng, n // 2, variety, op, dtype, seed + 7)
            tk0, tv0, _, _ = kv_aggregate.fpe_scan(rk, rv, n_buckets=nb,
                                                   ways=ways, op=op)
        want = kv_aggregate.fpe_scan(keys, vals, n_buckets=nb, ways=ways,
                                     op=op, table_keys=tk0,
                                     table_values=tv0)
        got = kv_aggregate.fpe_scan(
            keys.cuda(), vals.cuda(), n_buckets=nb, ways=ways, op=op,
            table_keys=None if tk0 is None else tk0.cuda(),
            table_values=None if tv0 is None else tv0.cuda())
        torch.cuda.synchronize()
        label = (f"fpe {op} {str(dtype).split('.')[-1]} capacity={capacity} "
                 f"ways={ways} resume={resume}")
        return (_fpe_compare(label, op, got, want),
                kv_aggregate.table_in_shared(nb, ways, vals.shape[1], dtype),
                table_bytes(nb, ways, vals.shape[1], dtype) > SMEM_DEFAULT)

    for op, dtypes in FPE_SWEEP:
        for dtype in dtypes:
            keys, vals = _fpe_stream(rng, n, variety, op, dtype, seed)
            for capacity, ways in FPE_GEOMETRIES:
                for resume in (False, True):
                    err, smem, opt_in = run_case(op, dtype, capacity, ways,
                                                 keys, vals, resume)
                    check(smem, f"{capacity}x{ways} should fit shared memory")
                    max_err = max(max_err, err)
                    cases += 1
                    n_opt_in += opt_in
    n_smem = cases
    check(n_opt_in > 0, "no case took the shared-memory opt-in launch")
    # the global-memory table: 65536 x (4 + 2 x 4) bytes > 227 KB
    keys, vals = _fpe_stream(rng, n, variety, "mean", F32, seed + 1)
    for resume in (False, True):
        err, smem, _ = run_case("mean", F32, 65536, 4, keys, vals, resume)
        check(not smem, "the 65536-slot mean table should live in global "
                        "memory")
        max_err = max(max_err, err)
        cases += 1

    # exact_stream=False through the "cuda" wrapper: the Pallas fast-mode
    # contract (pre-combine, [n] stream).  Integer-valued f32 values, so
    # the pre-combine's sums do not depend on index_add_'s order.
    keys = torch.from_numpy(rm.zipf_keys(n, variety, seed=seed + 2)
                            .astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.integers(-8, 8, n).astype(np.float32)).cuda()
    tk, tv, ek, ev = kv_aggregate.fpe_aggregate_cuda(
        keys, vals, capacity=1024, ways=4, op="sum", exact_stream=False)
    fast = kvagg.fpe_aggregate(keys, vals, capacity=1024, ways=4, op="sum",
                               exact_stream=False)
    check(ek.shape == (n,), "fast-mode eviction stream must be [n]")
    check(torch.equal(tk, fast.table_keys)
          and torch.equal(tv, fast.table_values),
          "fast-mode table differs from kvagg's fast path")
    grouped = kvagg.sorted_combine(torch.cat([tk, ek]), torch.cat([tv, ev]))
    direct = kvagg.sorted_combine(keys, vals)
    check(torch.equal(grouped.unique_keys[:int(grouped.n_unique)],
                      direct.unique_keys[:int(direct.n_unique)])
          and torch.equal(grouped.combined_values[:int(grouped.n_unique)],
                          direct.combined_values[:int(direct.n_unique)]),
          "fast-mode grouped totals differ from the input's")
    cases += 1
    emit("fpe_kernel_vs_plain", cases=cases, shared_memory_cases=n_smem,
         opt_in_shared_memory_cases=n_opt_in, global_memory_cases=2, n=n,
         key_variety=variety,
         geometries=[list(g) for g in FPE_GEOMETRIES] + [[65536, 4]],
         max_abs_err=max_err,
         logsumexp_tol={"float32": "rtol 1e-6, atol 1e-6",
                        "bfloat16": "one bf16 ulp (2**-7 relative)"},
         others="bit-identical", seconds=time.perf_counter() - t0)
    return max_err


# ---------------------------------------------------------------------------
# 3. top-k kernel vs its plain version
# ---------------------------------------------------------------------------


def phase_topk_kernel_vs_plain(seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    ties = torch.zeros((3, 64), device="cuda")
    ties[1] = 1.0
    ties[2, 5] = -2.0
    ties[2, 9] = 2.0
    cases = [
        ("gradient", torch.randn((6144, 4096), generator=g, device="cuda"),
         41),
        ("ragged", torch.randn((13, 100), generator=g, device="cuda"), 7),
        ("ties_and_zeros", ties, 5),
        ("bf16", torch.randn((64, 4096), generator=g, device="cuda")
         .to(torch.bfloat16), 41),
    ]
    out, err = {}, 0.0
    for name, x, k in cases:
        v, i = topk_compress.topk_rows(x, k=k)
        pv, pi = topk_compress.topk_rows_plain(x, k)
        torch.cuda.synchronize()
        check(torch.equal(i, pi), f"top-k {name}: indices differ")
        check(torch.equal(bits(v), bits(pv)), f"top-k {name}: values differ")
        err = max(err, float((v.double() - pv.double()).abs().max()))
        out[name] = {"shape": list(x.shape), "k": k,
                     "dtype": str(x.dtype).split(".")[-1]}
    x, k = cases[0][1], cases[0][2]
    rows, cols = x.shape
    kernel = cuda_ms(lambda: topk_compress.topk_rows(x, k=k), iters=20)
    plain = cuda_ms(lambda: topk_compress.topk_rows_plain(x, k), iters=5)
    library = cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), iters=20)
    b_ms, b_by = bound(rows * cols * 4 + rows * k * 8, rows * cols)
    emit("topk_kernel_vs_plain", cases=out, max_abs_err=err,
         timed_shape=[rows,
         cols], k=k, kernel_ms=kernel, plain_ms=plain, library_ms=library,
         library_call="torch.topk(x.abs(), k, dim=1)", bound_ms=b_ms,
         bound_by=b_by)
    return {"ms": kernel, "plain_ms": plain, "library_ms": library,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "shape": f"x [{rows}, {cols}] f32, k={k}"}


# ---------------------------------------------------------------------------
# 4-6. the main path
# ---------------------------------------------------------------------------


def two_level(capacity: int) -> CascadePlan:
    spec = LevelSpec(capacity=capacity, ways=4, bpe=True)
    return CascadePlan(op="sum", levels=(spec, spec))


def packed(res) -> tuple[torch.Tensor, torch.Tensor]:
    """The real (key, value) pairs of a cascade's packed root."""
    real = res.keys != EMPTY
    return res.keys[real], res.values[real]


def _levels(res, plan, data_amount, key_variety) -> list:
    preds = dataplane.predicted_level_reductions(plan, data_amount,
                                                 key_variety)
    rep = dataplane.telemetry(res, plan)["levels"]
    for lvl, p in zip(rep, preds):
        lvl["predicted_reduction"] = round(p, 4)
    return rep


def phase_wordcount(seed: int, launches: dict) -> dict:
    mappers, per_mapper, variety = 8, 1 << 20, 1 << 20
    n = mappers * per_mapper
    keys = torch.from_numpy(
        rm.zipf_keys(n, variety, skew=0.99, seed=seed).astype(np.int32)
    ).cuda()
    ones = torch.ones((n,), device="cuda")
    want = torch.bincount(keys.long(), minlength=variety).float()
    for capacity in (16384, 262144):
        plan = two_level(capacity)
        t0 = time.perf_counter()
        res, used = counted(lambda: dataplane.run_cascade(
            keys, ones, plan, backend="cuda"))
        wall = (time.perf_counter() - t0) * 1e3
        check(used["fpe_aggregate"] > 0, "word count ran no FPE kernel")
        for name, c in used.items():
            launches[name] += c
        real = res.keys != EMPTY
        got = torch.zeros((variety,), device="cuda")
        got[res.keys[real].long()] = res.values[real]
        check(torch.equal(got, want),
              f"word-count root differs from bincount at capacity {capacity}")
        nb = capacity // 4
        emit("wordcount", pairs=n, mappers=mappers, key_variety=variety,
             skew=0.99, capacity=capacity, ways=4,
             table_in_shared_memory=kv_aggregate.table_in_shared(
                 nb, 4, 1, torch.float32),
             levels=_levels(res, plan, n, variety),
             end_to_end_reduction=float(dataplane.end_to_end_reduction(res)),
             root_equals_bincount=True, wall_ms=wall,
             pairs_per_s=n / (wall / 1e3), launches=used)

    # where the time goes at capacity 16384, on the card's clock: each
    # level, the FPE kernel alone on that level's input, the root combine
    plan = two_level(16384)
    k, v, split = keys, ones, []
    for i, spec in enumerate(plan.levels):
        _, fpe_ms = timed(kv_aggregate.fpe_aggregate_cuda, k, v,
                          capacity=spec.capacity, ways=spec.ways)
        slots = int(k.shape[0])
        (k, v, _), level_ms = timed(dataplane.run_level, k, v, spec, "sum",
                                    backend="cuda")
        split.append({"level": i, "input_slots": slots, "level_ms": level_ms,
                      "fpe_kernel_ms": fpe_ms})
    _, root_ms = timed(kvagg.sorted_combine, k, v)
    full = split[0]["fpe_kernel_ms"]

    # the kernel against its plain scan at the main path's geometry (a
    # 128 KB table, the opt-in launch), on the first 2**17 pairs: held
    # bit for bit, then timed
    vals = ones[:, None]
    m = 1 << 17
    kp, vp = keys[:m].contiguous(), vals[:m].contiguous()
    kc, vc = kp.cpu(), vp.cpu()
    t0 = time.perf_counter()
    want = kv_aggregate.fpe_scan(kc, vc, n_buckets=4096, ways=4, op="sum")
    plain = (time.perf_counter() - t0) * 1e3
    got = kv_aggregate.fpe_scan(kp, vp, n_buckets=4096, ways=4, op="sum")
    torch.cuda.synchronize()
    err = _fpe_compare(f"fpe word count, first {m} pairs, capacity=16384 "
                       "ways=4", "sum", got, want)
    n_evict = int((want[2] != EMPTY).sum())
    check(n_evict > 0, "the word-count prefix evicted nothing")
    kernel = cuda_ms(lambda: kv_aggregate.fpe_scan(
        kp, vp, n_buckets=4096, ways=4, op="sum"), iters=5)
    cap_bytes = 16384 * 8

    def fpe_bound(pairs):  # pairs in, eviction slots out, table out
        return bound(pairs * 8 * 2 + cap_bytes, pairs)

    b_ms, b_by = fpe_bound(m)
    b_full, _ = fpe_bound(n)
    emit("fpe_timing", levels=split, root_combine_ms=root_ms, n_full=n,
         kernel_ms_full=full, bound_ms_full=b_full, n=m, kernel_ms=kernel,
         plain_ms=plain, bound_ms=b_ms, bound_by=b_by, plain_runs_on="cpu",
         evictions=n_evict, max_abs_err=err, equals_plain_scan=True)
    return {"ms": kernel, "plain_ms": plain, "library_ms": None,
            "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"first {m} pairs of the word-count stream, "
                     "capacity 16384, ways 4, f32",
            "ms_full": full, "bound_ms_full": b_full, "n_full": n}


def phase_grad_exchange(seed: int, launches: dict) -> None:
    d_ff, d_model, workers, chunk, k = 8192, 3072, 8, 4096, 41
    size = d_ff * d_model
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    grads = [torch.randn((d_ff, d_model), generator=g, device="cuda")
             for _ in range(workers)]
    states = [compressor.init_state((d_ff, d_model), device="cuda")
              for _ in range(workers)]
    plan = two_level(16384)

    def drive():
        outs = [ops.compress_grad(gr, st.residual, k=k, chunk=chunk)
                for gr, st in zip(grads, states)]
        keys = torch.cat([o[0] for o in outs])
        vals = torch.cat([o[1] for o in outs])
        res = dataplane.run_cascade(keys, vals, plan, backend="cuda")
        return outs, res, compressor.decompress_sum(res.keys, res.values,
                                                    size=size)

    t0 = time.perf_counter()
    (outs, res, dense), used = counted(drive)
    wall = (time.perf_counter() - t0) * 1e3
    check(used["topk_rows"] >= workers, f"top-k launches {used}")
    check(used["fpe_aggregate"] >= 2, f"FPE launches {used}")
    for name, c in used.items():
        launches[name] += c

    # the plain path: plain top-k per worker, then a dense scatter-add
    plain_keys, plain_vals = [], []
    rows = size // chunk
    base = torch.arange(rows, dtype=torch.int32, device="cuda")[:, None]
    for w, (gr, (gk, gv, gres)) in enumerate(zip(grads, outs)):
        acc = gr.reshape(-1).clone()
        pv, pi = topk_compress.topk_rows_plain(acc.reshape(rows, chunk), k)
        pk = (pi + base * chunk).reshape(-1)
        check(torch.equal(gk, pk) and torch.equal(gv, pv.reshape(-1)),
              f"worker {w}: compressed pairs differ from the plain top-k")
        acc.index_fill_(0, pk.long(), 0.0)
        check(torch.equal(gres.reshape(-1), acc),
              f"worker {w}: residual differs")
        plain_keys.append(pk)
        plain_vals.append(pv.reshape(-1))
    pk, pv = torch.cat(plain_keys), torch.cat(plain_vals)
    want = torch.zeros((size,), device="cuda").index_add_(0, pk.long(), pv)
    real = res.keys != EMPTY
    check(torch.equal(torch.sort(res.keys[real]).values, torch.unique(pk)),
          "root key set differs from the workers' keys")
    check(int(res.n_in) == pk.shape[0], "cascade input count differs")
    # BPE index_add_ on the card sums in no fixed order
    check(torch.allclose(dense, want, rtol=1e-5, atol=1e-6),
          "decompressed gradient sum differs from the plain path")
    emit("grad_exchange", workers=workers, grad_shape=[d_ff, d_model],
         chunk=chunk, k=k, pairs=int(pk.shape[0]),
         distinct_keys=int(real.sum()),
         compression_ratio=compressor.compression_ratio(
             (d_ff, d_model), rows * k),
         levels=_levels(res, plan, int(pk.shape[0]), size),
         max_abs_err=float((dense - want).abs().max()),
         tolerance="rtol 1e-5, atol 1e-6", wall_ms=wall, launches=used)


def phase_stream(seed: int, launches: dict) -> None:
    n, variety = 1 << 18, 1 << 16
    keys = rm.zipf_keys(n, variety, seed=seed + 2).astype(np.int32)
    vals = np.ones((n,), np.float32)
    rp = wire.RECORDS_PER_PACKET
    packets = [(keys[i:i + rp], vals[i:i + rp]) for i in range(0, n, rp)]
    plan = two_level(4096)
    t0 = time.perf_counter()
    res, used = counted(lambda: dataplane.run_cascade_stream(
        iter(packets), plan, device="cuda"))
    wall = (time.perf_counter() - t0) * 1e3
    check(used["fpe_aggregate"] >= len(packets),
          f"{used['fpe_aggregate']} FPE launches for {len(packets)} packets")
    for name, c in used.items():
        launches[name] += c
    ref = dataplane.run_cascade(torch.from_numpy(keys).cuda(),
                                torch.from_numpy(vals).cuda(), plan)
    (sk, sv), (rk, rv) = packed(res), packed(ref)
    check(torch.equal(sk, rk) and torch.equal(sv, rv),
          "streamed root differs from run_cascade's root")
    emit("stream", pairs=n, key_variety=variety, records_per_packet=rp,
         packets=len(packets), capacity=4096,
         levels=_levels(res, plan, n, variety), root_equals_run_cascade=True,
         wall_ms=wall, pairs_per_s=n / (wall / 1e3), launches=used)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    fpe_err = phase_fpe_kernel_vs_plain(args.seed)
    topk = phase_topk_kernel_vs_plain(args.seed)
    launches = {"fpe_aggregate": 0, "topk_rows": 0}
    fpe = phase_wordcount(args.seed, launches)
    phase_grad_exchange(args.seed, launches)
    phase_stream(args.seed, launches)
    for name, c in launches.items():
        check(c > 0, f"the main path never launched {name}")

    fpe.update(name="fpe_aggregate", route="cuda",
               source="src/repro_torch/kernels/csrc/fpe_aggregate.cu",
               replaces="src/repro/kernels/kv_aggregate.py:62",
               launches=launches["fpe_aggregate"],
               max_abs_err=max(fpe_err, fpe["max_abs_err"]))
    topk.update(name="topk_rows", route="triton",
                source="src/repro_torch/kernels/topk_compress.py",
                replaces="src/repro/kernels/topk_compress.py:29",
                launches=launches["topk_rows"])
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": [fpe, topk]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
