#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Needs one NVIDIA GPU (written for an H100).  It builds the port's three
CUDA kernels from this checkout, one nvcc each, all at once -- the FPE
hash-combine engine (``kernels/csrc/fpe_aggregate.cu``), the per-row
top-k (``kernels/csrc/topk_rows.cu``) and the BPE's in-order segmented
sum (``kernels/csrc/segment_sum.cu``) -- holds each against its plain
torch version, then drives the slice's main path through the entry
points a user calls:

  wordcount      the paper's MapReduce word count: 8 x 1 M Zipf-0.99
                 pairs through a 2-level ``run_cascade(backend="cuda")``;
  grad_exchange  8 workers' phi4-mini MLP gradients (8192 x 3072) through
                 ``kernels.ops.compress_grad``, a 2-level sum cascade and
                 ``compressor.decompress_sum``;
  stream         ``run_cascade_stream`` over 59-record packets, the FPE
                 kernel resumed from the resident table on every ingest;
  sim            the packet simulator (``net.simulate``): (a) a small job
                 on both engines on the card and on the CPU, bit for bit,
                 and a two-job batch; (b) the paper's word count at full
                 size through ``jct_comparison``, one multi-table FPE
                 launch per aggregating tier; (c) a 512-mapper tree at 1%
                 loss, delivered exactly once.

Each phase prints one JSON line; any mismatch raises (non-zero exit, no
result line).  The kernel launch counters are set to 0 just before each
main-path phase and read just after it; launches made to compare a kernel
with its plain version are not counted.  The line before the last is the
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
from repro_torch.kernels import segment_sum, topk_compress  # noqa: E402
from repro_torch.net import sim as netsim  # noqa: E402
from repro_torch.net import simulate, vsim, wire  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

EMPTY = kvagg.EMPTY_KEY
#: H100 SXM data sheet: HBM3 bandwidth, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: the kernels of the main path: name -> (wrapper module, source)
KERNELS = {"fpe_aggregate": kv_aggregate, "topk_rows": topk_compress,
           "segment_sum": segment_sum}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def counted(fn):
    """Run ``fn`` with every launch counter set to 0; return its result
    and the launches it made (``fpe_scan_tables``: the FPE kernel's
    multi-table launches, counted among ``fpe_aggregate``'s too)."""
    for mod in KERNELS.values():
        mod.launches = 0
    kv_aggregate.table_launches = 0
    out = fn()
    torch.cuda.synchronize()
    used = {name: mod.launches for name, mod in KERNELS.items()}
    used["fpe_scan_tables"] = kv_aggregate.table_launches
    return out, used


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


class Build(threading.Thread):
    """One nvcc for each CUDA source, all started together, in the
    background: the plain scans of the FPE check run meanwhile."""

    def __init__(self):
        super().__init__(name="nvcc")
        self.error: BaseException | None = None
        self.t0 = time.perf_counter()

    def run(self) -> None:
        try:
            _build.build_all(KERNELS)
        except BaseException as e:  # re-raised by wait(), in the main thread
            self.error = e

    def wait(self) -> None:
        t = time.perf_counter()
        self.join()
        if self.error is not None:
            raise self.error
        emit("build", build_s=dict(_build.build_seconds),
             build_total_s=time.perf_counter() - self.t0,
             waited_s=time.perf_counter() - t)


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
    info = {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit("device", **info)
    return info


# ---------------------------------------------------------------------------
# 2. FPE kernel vs its plain scan
# ---------------------------------------------------------------------------

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
FPE_SWEEP = (("sum", (F32, BF16, I32)), ("max", (F32, BF16, I32)),
             ("min", (F32, BF16, I32)), ("count", (I32,)),
             ("mean", (F32, BF16)), ("logsumexp", (F32, BF16)))
#: (capacity, ways); ways <= 4 walk a bucket with one thread, 8 and 64
#: with one warp; 16384 x 4 is the main path's level table
FPE_GEOMETRIES = ((64, 1), (1024, 4), (4096, 8), (2048, 64), (16384, 4))
#: streams past the one-launch path's SMALL_N take the partitioned path
FPE_N = {"partitioned": 8192, "one_launch": 2048}
ADVERSARIAL = ("one_key", "one_bucket_distinct", "all_distinct",
               "all_pads", "empty", "single")


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


def _adversarial(case: str, n: int, n_buckets: int, rng):
    """Streams that stress the bucket walk: one key (a chain of n hits),
    one bucket of distinct keys (a chain of n, an eviction per pair past
    the row), all keys distinct, pads only, n = 0, n = 1."""
    if case == "one_key":
        keys = np.full(n, 4242, np.int32)
    elif case == "one_bucket_distinct":
        cand = np.arange(64 * n * n_buckets, dtype=np.int64)
        hit = aggops.hash_key(torch.from_numpy(cand).to(torch.int32),
                              n_buckets).numpy() == 1
        keys = cand[hit][:n].astype(np.int32)
    elif case == "all_distinct":
        keys = rng.permutation(1 << 24)[:n].astype(np.int32)
    elif case == "all_pads":
        keys = np.full(n, EMPTY, np.int32)
    elif case == "empty":
        keys = np.zeros(0, np.int32)
    else:
        keys = np.array([9], np.int32)
    vals = rng.standard_normal((keys.shape[0], 1)).astype(np.float32)
    return torch.from_numpy(keys), torch.from_numpy(vals)


def _fpe_compare(label: str, got, want) -> float:
    """Raise unless the kernel's (table, evictions) equal the plain scan's
    bit for bit.  Returns the largest absolute value difference (0)."""
    names = ("table_keys", "table_values", "evict_keys", "evict_values")
    for name, g, w in zip(names, got, want):
        g = g.cpu()
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label} {name}: {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        check(torch.equal(bits(g), bits(w)), f"{label} {name} differ")
    return 0.0


def phase_fpe_kernel_vs_plain(seed: int, build: Build) -> float:
    """Every case's plain scan first (while the kernels build), then each
    kernel run held against it."""
    rng = np.random.default_rng(seed)
    variety = 16384
    counts = {"partitioned": 0, "one_launch": 0, "adversarial": 0}
    cases = []
    t0 = time.perf_counter()

    def add_case(op, dtype, capacity, ways, keys, vals, resume, path):
        ways, nb, cap = kvagg._fpe_geometry(capacity, ways)
        tk0 = tv0 = None
        if resume:  # a resident table from an earlier stream
            rk, rv = _fpe_stream(rng, 4096, variety, op, dtype, seed + 7)
            tk0, tv0, _, _ = kv_aggregate.fpe_scan(rk, rv, n_buckets=nb,
                                                   ways=ways, op=op)
        want = kv_aggregate.fpe_scan(keys, vals, n_buckets=nb, ways=ways,
                                     op=op, table_keys=tk0,
                                     table_values=tv0)
        label = (f"fpe {op} {str(dtype).split('.')[-1]} capacity={capacity} "
                 f"ways={ways} resume={resume} n={keys.shape[0]}")
        cases.append((label, path, op, nb, ways, keys, vals, tk0, tv0, want))

    for op, dtypes in FPE_SWEEP:
        for dtype in dtypes:
            for path, n in FPE_N.items():
                keys, vals = _fpe_stream(rng, n, variety, op, dtype, seed)
                for capacity, ways in FPE_GEOMETRIES:
                    # the one-launch path: resumed only (a streamed ingest)
                    for resume in ((False, True) if path == "partitioned"
                                   else (True,)):
                        add_case(op, dtype, capacity, ways, keys, vals,
                                 resume, path)
    # a 65,536-slot table, as the 262,144-capacity word count's scale
    keys, vals = _fpe_stream(rng, FPE_N["partitioned"], variety, "mean", F32,
                             seed + 1)
    for resume in (False, True):
        add_case("mean", F32, 65536, 4, keys, vals, resume, "partitioned")
    for case in ADVERSARIAL:
        for n in (3000, 9000):
            if case in ("empty", "single") and n == 9000:
                continue
            for capacity, ways in ((16, 1), (64, 4), (128, 8), (1024, 64)):
                ways, nb, _ = kvagg._fpe_geometry(capacity, ways)
                keys, vals = _adversarial(case, n, nb, rng)
                add_case("sum", F32, capacity, ways, keys, vals, False,
                         "adversarial")
    plain_s = time.perf_counter() - t0

    build.wait()
    for label, path, op, nb, ways, keys, vals, tk0, tv0, want in cases:
        got = kv_aggregate.fpe_scan(
            keys.cuda(), vals.cuda(), n_buckets=nb, ways=ways, op=op,
            table_keys=None if tk0 is None else tk0.cuda(),
            table_values=None if tv0 is None else tv0.cuda())
        torch.cuda.synchronize()
        _fpe_compare(label, got, want)
        counts[path] += 1

    # exact_stream=False through the "cuda" wrapper: the Pallas fast-mode
    # contract (pre-combine, [n] stream).  Integer-valued f32 values, so
    # the pre-combine's sums are exact in any order.
    n = FPE_N["partitioned"]
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
    counts["partitioned"] += 1
    emit("fpe_kernel_vs_plain", cases=sum(counts.values()),
         cases_by_path=counts, n=FPE_N, key_variety=variety,
         geometries=[list(g) for g in FPE_GEOMETRIES] + [[65536, 4]],
         adversarial=list(ADVERSARIAL), max_abs_err=0.0,
         compared="bit for bit, every op (logsumexp included)",
         plain_seconds=plain_s, seconds=time.perf_counter() - t0)
    return 0.0


# ---------------------------------------------------------------------------
# 3. top-k kernel vs its plain version
# ---------------------------------------------------------------------------


def phase_topk_kernel_vs_plain(seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    ties = torch.zeros((3, 64), device="cuda")
    ties[1] = 1.0
    ties[2, 5] = -2.0
    ties[2, 9] = 2.0
    # NaN ranks above +inf (ties to the lower column), -0.0 equals 0
    special = torch.randn((6, 4096), generator=g, device="cuda")
    special[0, [7, 100, 3000]] = float("nan")
    special[0, [5, 2000]] = float("inf")
    special[0, 6] = -float("inf")
    special[1, :] = 0.0
    special[1, 1::2] = -0.0
    special[2, :] = -3.0  # all magnitudes equal
    special[3, :] = float("nan")
    special[4, 10::40] = float("inf")
    # denormal magnitudes rank as 0 (XLA flushes them), ties in column
    # order after the row's normal values; the values keep their bits
    special[5, :] = torch.randint(-3, 4, (4096,), generator=g,
                                  device="cuda") * 1e-40
    special[5, [9, 700]] = torch.tensor([0.5, -7.0], device="cuda")
    cases = [
        ("gradient", torch.randn((6144, 4096), generator=g, device="cuda"),
         41),
        ("ragged", torch.randn((13, 100), generator=g, device="cuda"), 7),
        ("ties_and_zeros", ties, 5),
        ("bf16", torch.randn((64, 4096), generator=g, device="cuda")
         .to(torch.bfloat16), 41),
        ("nan_inf_negzero", special, 41),
        ("nan_inf_negzero_bf16", special.to(torch.bfloat16), 41),
        ("k_equals_cols", torch.randn((9, 96), generator=g, device="cuda"),
         96),
        ("wide_k", torch.randn((7, 3000), generator=g, device="cuda"), 300),
    ]
    out, err = {}, 0.0
    for name, x, k in cases:
        v, i = topk_compress.topk_rows(x, k=k)
        pv, pi = topk_compress.topk_rows_plain(x, k)
        torch.cuda.synchronize()
        check(torch.equal(i, pi), f"top-k {name}: indices differ")
        check(torch.equal(bits(v), bits(pv)), f"top-k {name}: values differ")
        d = (v.double() - pv.double()).abs()
        err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
        out[name] = {"shape": list(x.shape), "k": k,
                     "dtype": str(x.dtype).split(".")[-1]}
    x, k = cases[0][1], cases[0][2]
    rows, cols = x.shape
    kernel = cuda_ms(lambda: topk_compress.topk_rows(x, k=k), iters=20)
    plain = cuda_ms(lambda: topk_compress.topk_rows_plain(x, k), iters=5)
    library = cuda_ms(lambda: torch.topk(x.abs(), k, dim=1), iters=20)
    b_ms, b_by = bound(rows * cols * 4 + rows * k * 8, rows * cols)
    emit("topk_kernel_vs_plain", cases=out, max_abs_err=err,
         timed_shape=[rows, cols], k=k, kernel_ms=kernel, plain_ms=plain,
         library_ms=library,
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


def chain_pairs(keys: torch.Tensor, n_buckets: int) -> int:
    """The longest bucket chain of a stream: the most real pairs that
    hash to one bucket (what bounds the FPE kernel's walk)."""
    real = keys[keys != EMPTY]
    if not real.numel():
        return 0
    return int(torch.bincount(aggops.hash_key(real, n_buckets).long(),
                              minlength=n_buckets).max())


def bpe_segment_sum(ek: torch.Tensor, ev: torch.Tensor) -> dict:
    """The segment-sum kernel on the BPE's input at the main path's shape
    (level 0's eviction stream, grouped as ``kvagg._group_reduce`` groups
    it), held against its plain version bit for bit, then timed."""
    n = ek.shape[0]
    k_s, perm = torch.sort(ek, stable=True)
    seg = torch.where(k_s == EMPTY, -1, torch.searchsorted(k_s, k_s))
    vals = ev[perm].contiguous()
    got = segment_sum.segment_sum(vals, seg, n, ids_grouped=True)
    segc, valc = seg.cpu(), vals.cpu()
    t0 = time.perf_counter()
    want = segment_sum.segment_sum_plain(valc, segc, n)
    plain = (time.perf_counter() - t0) * 1e3
    check(torch.equal(bits(got.cpu()), bits(want)),
          "segment sum differs from its plain version on the BPE's input")
    kernel = cuda_ms(lambda: segment_sum.segment_sum(vals, seg, n,
                                                     ids_grouped=True))
    lib_ids = torch.where(seg < 0, n, seg)  # pads into a spare segment
    library = cuda_ms(lambda: torch.zeros(
        (n + 1,) + tuple(vals.shape[1:]), device="cuda").index_add_(
            0, lib_ids, vals))
    real = int((seg >= 0).sum())
    # ids and values read once, the sums written once; one add a real pair
    b_ms, b_by = bound(n * 8 + n * vals[0].numel() * 4 * 2, real)
    longest = int(torch.unique_consecutive(seg[seg >= 0],
                                           return_counts=True)[1].max())
    return {"ms": kernel, "plain_ms": plain, "library_ms": library,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
            "plain_runs_on": "cpu",
            "library_call": "index_add_ (atomics, no fixed order)",
            "shape": f"level-0 word-count eviction stream, {n} slots, "
                     f"{real} real, longest run {longest}"}


def phase_wordcount(seed: int, launches: dict) -> tuple[dict, dict]:
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
        emit("wordcount", pairs=n, mappers=mappers, key_variety=variety,
             skew=0.99, capacity=capacity, ways=4,
             chain_pairs=chain_pairs(keys, capacity // 4),
             levels=_levels(res, plan, n, variety),
             end_to_end_reduction=float(dataplane.end_to_end_reduction(res)),
             root_equals_bincount=True, wall_ms=wall,
             pairs_per_s=n / (wall / 1e3), launches=used)

    # where the time goes at capacity 16384, on the card's clock: each
    # level, the FPE kernel alone on that level's input (its partition
    # included, and alone), the root combine
    plan = two_level(16384)
    k, v, split = keys, ones, []
    for i, spec in enumerate(plan.levels):
        nb = spec.capacity // spec.ways
        _, part_ms = timed(kv_aggregate.partition, k, nb)
        fpe, fpe_ms = timed(kv_aggregate.fpe_aggregate_cuda, k, v,
                            capacity=spec.capacity, ways=spec.ways)
        if i == 0:
            bpe = bpe_segment_sum(fpe.evict_keys, fpe.evict_values)
        slots = int(k.shape[0])
        chain = chain_pairs(k, nb)
        (k, v, _), level_ms = timed(dataplane.run_level, k, v, spec, "sum",
                                    backend="cuda")
        split.append({"level": i, "input_slots": slots, "level_ms": level_ms,
                      "fpe_kernel_ms": fpe_ms, "partition_ms": part_ms,
                      "chain_pairs": chain})
    _, root_ms = timed(kvagg.sorted_combine, k, v)
    full = split[0]["fpe_kernel_ms"]

    # the kernel against its plain scan at the main path's geometry, on
    # the first 2**17 pairs: held bit for bit, then timed
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
                       "ways=4", got, want)
    n_evict = int((want[2] != EMPTY).sum())
    check(n_evict > 0, "the word-count prefix evicted nothing")
    kernel = cuda_ms(lambda: kv_aggregate.fpe_scan(
        kp, vp, n_buckets=4096, ways=4, op="sum"), iters=5)
    cap_bytes = 16384 * 8

    def fpe_bound(pairs):  # pairs in, eviction slots out, table out
        return bound(pairs * 8 * 2 + cap_bytes, pairs)

    b_ms, b_by = fpe_bound(m)
    b_full, _ = fpe_bound(n)
    chain = chain_pairs(kp, 4096)
    emit("fpe_timing", levels=split, root_combine_ms=root_ms, n_full=n,
         kernel_ms_full=full, bound_ms_full=b_full,
         chain_pairs_full=split[0]["chain_pairs"], n=m, kernel_ms=kernel,
         chain_pairs=chain, plain_ms=plain, library_ms=None, bound_ms=b_ms,
         bound_by=b_by, plain_runs_on="cpu", evictions=n_evict, max_abs_err=err,
         equals_plain_scan=True, bpe_segment_sum=bpe)
    return {"ms": kernel, "plain_ms": plain, "library_ms": None,
            "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "chain_pairs": chain,
            "shape": f"first {m} pairs of the word-count stream, "
                     "capacity 16384, ways 4, f32",
            "ms_full": full, "bound_ms_full": b_full, "n_full": n,
            "chain_pairs_full": split[0]["chain_pairs"]}, bpe


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
    # the plain path adds each key's values in worker order, the cascade
    # in its own grouping (FPE hits, then BPE partials, level by level):
    # f32 association, hence the tolerance.  No sum on the card adds in
    # an unfixed order, so the card path is deterministic, and on a slice
    # it equals the same cascade on the CPU bit for bit.
    want = segment_sum.segment_sum_plain(pv.cpu(), pk.cpu(), size).cuda()
    real = res.keys != EMPTY
    check(torch.equal(torch.sort(res.keys[real]).values, torch.unique(pk)),
          "root key set differs from the workers' keys")
    check(int(res.n_in) == pk.shape[0], "cascade input count differs")
    check(torch.allclose(dense, want, rtol=1e-5, atol=1e-6),
          "decompressed gradient sum differs from the plain path")
    _, res2, dense2 = drive()
    check(torch.equal(res2.keys, res.keys) and torch.equal(dense2, dense),
          "the gradient exchange is not deterministic on the card")
    sl = torch.cat([o[0][:64 * k] for o in outs]), torch.cat(
        [o[1][:64 * k] for o in outs])
    on_card = dataplane.run_cascade(*sl, plan, backend="cuda")
    on_cpu = dataplane.run_cascade(sl[0].cpu(), sl[1].cpu(), plan,
                                   backend="cuda")
    check(torch.equal(on_card.keys.cpu(), on_cpu.keys)
          and torch.equal(on_card.values.cpu(), on_cpu.values),
          "the cascade on the card differs from the CPU's on a slice")
    emit("grad_exchange", workers=workers, grad_shape=[d_ff, d_model],
         chunk=chunk, k=k, pairs=int(pk.shape[0]),
         distinct_keys=int(real.sum()),
         compression_ratio=compressor.compression_ratio(
             (d_ff, d_model), rows * k),
         levels=_levels(res, plan, int(pk.shape[0]), size),
         max_abs_err=float((dense - want).abs().max()),
         tolerance="rtol 1e-5, atol 1e-6 against the flat plain sum "
                   "(association)", deterministic=True,
         slice_pairs=int(sl[0].shape[0]), slice_equals_cpu_cascade=True,
         wall_ms=wall, launches=used)


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


# ---------------------------------------------------------------------------
# 7. the packet simulator
# ---------------------------------------------------------------------------

SIM_OPS = ("sum", "max", "logsumexp")


def _sim_identical(label: str, want, got) -> None:
    """Every observable of two sim runs equal, as the parity tests hold
    them (``tests/test_torch_sim.py``)."""
    check(got.report() == want.report(), f"{label}: report differs")
    check(got.delivered_table() == want.delivered_table(),
          f"{label}: delivered table differs")
    check(got.jct_s == want.jct_s, f"{label}: JCT differs")
    check(got.mapper_finish_s == want.mapper_finish_s,
          f"{label}: mapper finish times differ")
    check(got.retransmissions == want.retransmissions
          and got.packets_dropped == want.packets_dropped,
          f"{label}: retransmissions or drops differ")


def _levels_plan(capacity: int, n_levels: int, op: str = "sum"):
    spec = LevelSpec(capacity=capacity, ways=4, bpe=True)
    return CascadePlan(op=op, levels=(spec,) * n_levels)


def _equals_bincount(res, keys: np.ndarray, variety: int) -> bool:
    want = np.bincount(keys, minlength=variety).astype(np.float32)
    got = np.zeros((variety,), np.float32)
    got[res.delivered_keys] = res.delivered_values
    return (res.delivered_records == int((want > 0).sum())
            and np.array_equal(got, want))


def sim_parity(seed: int) -> dict:
    """(a) One small job, every op of ``SIM_OPS`` in both stream modes at
    loss 0 and 1%: both engines on the card equal the vectorized engine
    on the CPU (the kernels' plain versions); then a two-job batch equals
    its solo runs, one ``tier_ingest`` call and one multi-table launch a
    tier."""
    mappers, per, variety = 8, 4096, 1 << 16
    n = mappers * per
    keys = rm.zipf_keys(n, variety, skew=0.99, seed=seed + 3).astype(np.int32)
    vals = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    t0 = time.perf_counter()
    configs = 0
    retx = 0
    for op in SIM_OPS:
        for exact in (True, False):
            for loss in (0.0, 0.01):
                cfg = netsim.NetConfig(exact_stream=exact, loss_rate=loss,
                                       seed=seed)
                spec = netsim.JobSpec(keys=keys, values=vals, fanins=(4, 2),
                                      plan=_levels_plan(1024, 2, op), cfg=cfg)
                label = f"sim {op} exact_stream={exact} loss={loss}"
                want = simulate(spec, engine="vectorized", device="cpu")
                for engine in ("vectorized", "node"):
                    got = simulate(spec, engine=engine, device="cuda")
                    _sim_identical(f"{label} {engine} engine on the card",
                                   want, got)
                check(loss == 0.0 or want.retransmissions > 0,
                      f"{label}: no retransmission at 1% loss")
                retx += want.retransmissions
                configs += 1
    cfg = netsim.NetConfig(seed=seed, engine="vectorized")
    specs = [netsim.JobSpec(
        keys=rm.zipf_keys(n, variety, skew=0.99, seed=seed + 3 + j)
        .astype(np.int32), values=vals, fanins=(4, 2),
        plan=_levels_plan(1024, 2), cfg=cfg, job_id=j) for j in range(2)]
    solo = [simulate(sp, device="cuda") for sp in specs]
    calls = vsim.ingest_calls
    batch, used = counted(lambda: simulate(specs, device="cuda"))
    calls = vsim.ingest_calls - calls
    check(calls == 2 and used["fpe_scan_tables"] == 2,
          f"the two-job batch made {calls} tier_ingest calls and "
          f"{used['fpe_scan_tables']} multi-table launches, not 2 and 2")
    for j, (a, b) in enumerate(zip(solo, batch)):
        _sim_identical(f"sim batch job {j} vs its solo run", a, b)
    return {"pairs": n, "mappers": mappers, "key_variety": variety,
            "fanins": [4, 2], "capacity": 1024, "ops": list(SIM_OPS),
            "configs": configs, "runs": 3 * configs,
            "compared": "node and vectorized engines on the card vs the "
                        "vectorized engine on the CPU, bit for bit",
            "retransmissions": retx, "batch_jobs": len(specs),
            "batch_tier_ingest_calls": calls, "seconds":
            time.perf_counter() - t0}


def _spans(tracer, name: str) -> list:
    return [e for e in tracer.events if e["name"] == name]


def leg_wall_ms(tracer, tag: str) -> float:
    """A job's wall time inside a lockstep batch, from the engine's own
    spans: its host steps plus the dispatches that carried only its
    tiers."""
    us = sum(e["dur"] for e in tracer.events
             if e["name"] in ("sim.start_tier", "sim.finish_tier")
             and e["args"]["job"] == tag)
    us += sum(e["dur"] for e in _spans(tracer, "sim.dispatch")
              if e["args"]["jobs"] == [tag])
    return us / 1e3


def sim_wordcount(seed: int, launches: dict) -> dict:
    """(b) The paper's word count at full size through ``jct_comparison``
    on the vectorized engine: 8 mappers x 1 M Zipf-0.99 pairs over 1 M
    keys (the ``wordcount`` phase's data), 16,384 pairs a switch at both
    levels, 10 GbE links.  The run is traced: each tier's FPE launch and
    combine times, its longest (switch, bucket) run and each leg's wall
    time are read from the engine's spans, and the level-0 batch it fed
    the kernel is kept for :func:`fpe_tables_kernel`."""
    mappers, per, variety = 8, 1 << 20, 1 << 20
    n = mappers * per
    keys = rm.zipf_keys(n, variety, skew=0.99, seed=seed).astype(np.int32)
    vals = np.ones((n,), np.float32)
    plan = _levels_plan(16384, 2)
    cfg = netsim.NetConfig(link_gbps=(netsim.TEN_GBE,) * 2,
                           reducer_gbps=netsim.TEN_GBE, engine="vectorized")
    batches = []
    ingest = vsim.tier_ingest

    def keep_batch(keys_b, values_b, **kw):
        batches.append((keys_b, values_b, kw))
        return ingest(keys_b, values_b, **kw)

    vsim.tier_ingest = keep_batch
    try:
        with obs_trace.scoped_tracer() as tracer:
            t0 = time.perf_counter()
            out, used = counted(lambda: netsim.jct_comparison(
                keys, vals, fanins=(4, 2), plan=plan, cfg=cfg,
                device="cuda"))
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        vsim.tier_ingest = ingest
    check(used["fpe_scan_tables"] == 2 and used["fpe_aggregate"] == 2
          and len(batches) == 2,
          f"word-count sim launches {used}, {len(batches)} tier_ingest "
          "calls: not one FPE launch per tier")
    for name, c in used.items():
        launches[name] += c
    sw, host = out["_results"]
    check(_equals_bincount(sw, keys, variety),
          "sim word count (SwitchAgg) differs from bincount")
    check(_equals_bincount(host, keys, variety),
          "sim word count (host only) differs from bincount")
    check(out["jct_saved"] > 0.0, f"no JCT saved: {out['jct_saved']}")
    rep = out["switchagg"]
    tiers = [e["args"] | {"wall_ms": e["dur"] / 1e3}
             for e in _spans(tracer, "vsim.tier_ingest")]
    check([t["levels"] for t in tiers] == [[0], [1]],
          f"traced tier_ingest calls {[t['levels'] for t in tiers]}")
    for t, lv in zip(tiers, rep["per_level"]):
        check(t["real_pairs"] == lv["records_in"],
              f"level {lv['level']}: the traced batch holds "
              f"{t['real_pairs']} pairs, the report {lv['records_in']}")
    emit("sim_wordcount", pairs=n, mappers=mappers, key_variety=variety,
         skew=0.99, fanins=[4, 2], capacity=16384,
         link_gbps=netsim.TEN_GBE, wall_ms=wall,
         leg_wall_ms={leg: leg_wall_ms(tracer, leg)
                      for leg in ("switchagg", "host_only")},
         tiers=tiers, jct_switchagg_s=out["jct_switchagg_s"],
         jct_host_only_s=out["jct_host_only_s"], jct_saved=out["jct_saved"],
         reduction=out["reduction"],
         per_level=[{k: lv[k] for k in ("level", "records_in", "records_out",
                                        "evictions")}
                    | {"reduction": 1.0 - lv["records_out"]
                       / max(1, lv["records_in"])}
                    for lv in rep["per_level"]],
         delivered_equals_bincount=True, launches=used)
    return fpe_tables_kernel(batches[0], tiers[0])


def fpe_tables_kernel(batch, tier0: dict) -> dict:
    """The multi-table FPE launch on the batch the word count's level 0
    fed it (both switches' tables in one launch): timed; held bit for bit
    against one single-table launch a switch (the kernel path the
    ``fpe_kernel_vs_plain`` phase holds against the plain scan) over the
    whole batch, and against the plain version on each switch's first
    512 packets."""
    keys_b, values_b, kw = batch
    s_n, p_n, r = keys_b.shape
    k = keys_b.reshape(s_n, p_n * r).contiguous()
    v = values_b.reshape(s_n, p_n * r, 1).contiguous()
    ways, nb, _ = kvagg._fpe_geometry(kw["capacity"], kw["ways"])
    n = k.shape[1]

    def scan(ks, vs):
        return kv_aggregate.fpe_scan_tables(ks, vs, n_buckets=nb, ways=ways,
                                            op="sum")

    kernel = cuda_ms(lambda: scan(k, v), iters=3)
    got = scan(k, v)
    rows = [kv_aggregate.fpe_scan(k[s], v[s], n_buckets=nb, ways=ways,
                                  op="sum") for s in range(s_n)]
    torch.cuda.synchronize()
    _fpe_compare(f"fpe_scan_tables, word-count level 0, all {n} slots of "
                 f"{s_n} switches vs one launch a switch", got,
                 tuple(torch.stack(parts).cpu() for parts in zip(*rows)))
    m = 512 * r
    ks, vs = k[:, :m].contiguous(), v[:, :m].contiguous()
    kc, vc = ks.cpu(), vs.cpu()
    t0 = time.perf_counter()
    want = scan(kc, vc)
    plain = (time.perf_counter() - t0) * 1e3
    got = scan(ks, vs)
    torch.cuda.synchronize()
    err = _fpe_compare(f"fpe_scan_tables, word-count level 0, first {m} "
                       "slots of each switch vs the plain version", got, want)
    slice_ms = cuda_ms(lambda: scan(ks, vs), iters=5)
    # each slot's key and value read, its eviction slot and the tables
    # written; one combine a real pair
    b_ms, b_by = bound(s_n * n * 8 * 2 + s_n * nb * ways * 8,
                       tier0["real_pairs"])
    return {"ms": kernel, "plain_ms": plain, "library_ms": None,
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "chain_pairs": tier0["chain_pairs"],
            "shape": f"word-count level 0: {s_n} tables of 16384 pairs "
                     f"(4 ways), {n} slots each, f32",
            "checked": "whole batch bit for bit against one launch a "
                       f"switch; first {m} slots of each against the plain "
                       "version",
            "plain_shape": f"first {m} slots of each table (CPU)",
            "ms_slice": slice_ms, "plain_runs_on": "cpu"}


def sim_wide(seed: int, launches: dict) -> dict:
    """(c) A wide tree at 1% loss: fanins (16, 8, 4), 512 mappers, 32
    level-0 switches in one launch, 16,384 pairs a switch at every level;
    the delivered table must equal bincount (exactly once under loss)."""
    fanins, variety, per_mapper = (16, 8, 4), 1 << 20, 16384
    n = 512 * per_mapper
    keys = rm.zipf_keys(n, variety, skew=0.99, seed=seed + 5).astype(np.int32)
    vals = np.ones((n,), np.float32)
    spec = netsim.JobSpec(keys=keys, values=vals, fanins=fanins,
                          plan=_levels_plan(16384, 3),
                          cfg=netsim.NetConfig(loss_rate=0.01, seed=seed,
                                               engine="vectorized"))
    t0 = time.perf_counter()
    res, used = counted(lambda: simulate(spec, device="cuda"))
    wall = (time.perf_counter() - t0) * 1e3
    check(used["fpe_scan_tables"] == 3 and used["fpe_aggregate"] == 3,
          f"wide-tree sim launches {used}: not one FPE launch per tier")
    for name, c in used.items():
        launches[name] += c
    check(_equals_bincount(res, keys, variety),
          "wide-tree sim at 1% loss differs from bincount")
    check(res.retransmissions > 0 and res.duplicate_discards == 0,
          f"retransmissions {res.retransmissions}, duplicates "
          f"{res.duplicate_discards}")
    return {"pairs": n, "mappers": 512, "pairs_per_mapper": per_mapper,
            "fanins": list(fanins), "capacity": 16384, "loss_rate": 0.01,
            "level0_switches": 32, "retransmissions": res.retransmissions,
            "packets_dropped": res.packets_dropped, "timeouts": res.timeouts,
            "gap_discards": res.gap_discards, "jct_s": res.jct_s,
            "delivered_equals_bincount": True, "wall_ms": wall,
            "launches": used}


def phase_sim(seed: int, launches: dict) -> dict:
    t0 = time.perf_counter()
    parity = sim_parity(seed)
    emit("sim_parity", **parity)
    kernel = sim_wordcount(seed, launches)
    emit("sim_wide", **sim_wide(seed, launches))
    emit("sim", seconds=time.perf_counter() - t0)
    return kernel


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    build = Build()
    build.start()
    try:
        fpe_err = phase_fpe_kernel_vs_plain(args.seed, build)
    finally:
        build.join()  # no nvcc outlives the script, whatever failed
    topk = phase_topk_kernel_vs_plain(args.seed)
    launches = {name: 0 for name in KERNELS} | {"fpe_scan_tables": 0}
    fpe, bpe = phase_wordcount(args.seed, launches)
    phase_grad_exchange(args.seed, launches)
    phase_stream(args.seed, launches)
    tables = phase_sim(args.seed, launches)
    for name, c in launches.items():
        check(c > 0, f"the main path never launched {name}")

    fpe.update(name="fpe_aggregate", route="cuda",
               source="src/repro_torch/kernels/csrc/fpe_aggregate.cu",
               replaces="src/repro/kernels/kv_aggregate.py:62",
               launches=launches["fpe_aggregate"],
               max_abs_err=max(fpe_err, fpe["max_abs_err"]))
    topk.update(name="topk_rows", route="cuda",
                source="src/repro_torch/kernels/csrc/topk_rows.cu",
                replaces="src/repro/kernels/topk_compress.py:29",
                launches=launches["topk_rows"])
    # no Pallas kernel: the BPE's segment_sum is an XLA op in the JAX
    # package (its call in kvagg._group_reduce)
    bpe.update(name="segment_sum", route="cuda",
               source="src/repro_torch/kernels/csrc/segment_sum.cu",
               replaces="src/repro/core/kvagg.py:209",
               launches=launches["segment_sum"])
    # the same CUDA kernel, launched over every switch table of a tier
    tables.update(name="fpe_scan_tables", route="cuda",
                  source="src/repro_torch/kernels/csrc/fpe_aggregate.cu",
                  replaces="src/repro/kernels/kv_aggregate.py:62",
                  launches=launches["fpe_scan_tables"])
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": [fpe, topk, bpe, tables]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
