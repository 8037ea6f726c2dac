"""SwitchAgg analytic reduction model — Eq. (1)-(3) and Theorems 2.1/2.2.

This module is the paper-faithful analytic layer.  It is pure Python/NumPy
(no jax) so the planner can call it at trace time without entering a jit.
Byte-size assumptions (pair size, Ethernet-domain header, per-pair
metadata) come from ``net.wire`` — the single wire-format source
shared with the packet simulator (DESIGN.md §7), itself jax-free.

Paper quantities (all in units of one average KV pair unless noted):
    M  — data amount arriving at an aggregation node
    N  — key variety (number of distinct keys), N <= M
    C  — aggregation-node memory capacity (number of resident pairs)
    R  — reduction ratio: fraction of input traffic removed by the node

Eq. (3) of the paper, uniform key distribution:

    R = 1 - N/M          if N <= C
    R = (1/N - 1/M) * C  if N >  C

The attainable reduction is bounded by C/N — single-node memory capacity is
the dominant limit (paper §2.2.2, Fig. 2a).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from repro_torch.net import wire

# ---------------------------------------------------------------------------
# Eq. (1): extra-traffic ratio of fixed-format KV encapsulation (RMT/DAIET).
# ---------------------------------------------------------------------------


def fixed_format_extra_traffic(slot_bytes: int, pair_bytes: Sequence[int]) -> float:
    """Eq. (1): T = M / sum(P_i).

    ``slot_bytes`` is the fixed slot size N each pair is padded to; the packet
    carries ``len(pair_bytes)`` slots, so M = len(pair_bytes) * slot_bytes.
    Returns the multiplicative traffic factor (1.0 == no waste).
    """
    if not pair_bytes:
        raise ValueError("need at least one pair")
    if any(p <= 0 or p > slot_bytes for p in pair_bytes):
        raise ValueError("pair lengths must be in (0, slot_bytes]")
    total_payload = float(sum(pair_bytes))
    packet = float(len(pair_bytes) * slot_bytes)
    return packet / total_payload


def switchagg_extra_traffic(
    pair_bytes: Sequence[int],
    metadata_bytes: int = wire.PAIR_META_BYTES,
) -> float:
    """SwitchAgg's variable-length encoding: per-pair metadata instead of padding."""
    total_payload = float(sum(pair_bytes))
    encoded = total_payload + metadata_bytes * len(pair_bytes)
    return encoded / total_payload


# ---------------------------------------------------------------------------
# Eq. (2): header overhead of small-packet transport.
# ---------------------------------------------------------------------------


def header_overhead_bytes(
    data_bytes: int,
    max_payload: int,
    header_bytes: int = wire.ETH_HEADER_BYTES,
) -> int:
    """Eq. (2): T = D + floor(D / M) * H  (paper's formula, Ethernet domain)."""
    if max_payload <= 0:
        raise ValueError("max_payload must be positive")
    return data_bytes + (data_bytes // max_payload) * header_bytes


def header_overhead_ratio(
    max_payload: int,
    header_bytes: int = wire.ETH_HEADER_BYTES,
) -> float:
    """Asymptotic overhead ratio H/M (paper: 58/229 ≈ 25.3% for 200B RMT)."""
    return header_bytes / float(max_payload)


# ---------------------------------------------------------------------------
# Eq. (3): single-node reduction ratio, uniform keys.
# ---------------------------------------------------------------------------


def reduction_ratio(data_amount: float, key_variety: float, capacity: float) -> float:
    """Eq. (3).  All arguments in units of one KV pair."""
    m, n, c = float(data_amount), float(key_variety), float(capacity)
    if m <= 0 or n <= 0 or c < 0:
        raise ValueError("M, N must be positive; C non-negative")
    if n > m:
        raise ValueError("key variety N cannot exceed data amount M")
    if n <= c:
        return 1.0 - n / m
    return (1.0 / n - 1.0 / m) * c


def reduction_ratio_bound(key_variety: float, capacity: float) -> float:
    """Upper bound C/N when N > C (paper §2.2.2), else the N<=C ideal bound."""
    n, c = float(key_variety), float(capacity)
    return min(1.0, c / n)


# ---------------------------------------------------------------------------
# Stream simulators — used to *verify* Eq. (3) and Theorems 2.1 / 2.2.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeStats:
    """Traffic accounting for one simulated aggregation node."""

    input_pairs: int = 0
    output_pairs: int = 0  # evictions + final flush

    @property
    def reduction(self) -> float:
        if self.input_pairs == 0:
            return 0.0
        return 1.0 - self.output_pairs / self.input_pairs


class HashAggregationNode:
    """Faithful simulator of one SwitchAgg processing engine.

    Direct-mapped hash table of ``capacity`` slots (the paper uses buckets of
    a few slots; ``ways`` models that).  On collision the resident pair is
    EVICTED downstream (paper §4.2.4) — the engine never stalls.
    """

    def __init__(self, capacity: int, ways: int = 4, seed: int = 0x9E3779B9):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.ways = max(1, min(ways, capacity))
        self.buckets = max(1, capacity // self.ways)
        self.capacity = self.buckets * self.ways
        self._mult = (0x9E3779B97F4A7C15 ^ seed) & 0xFFFFFFFFFFFFFFFF
        # key -1 marks an empty slot
        self.keys = np.full((self.buckets, self.ways), -1, dtype=np.int64)
        self.values = np.zeros((self.buckets, self.ways), dtype=np.float64)
        self.stats = NodeStats()

    def _bucket(self, key: int) -> int:
        h = ((key & 0xFFFFFFFFFFFFFFFF) * self._mult) & 0xFFFFFFFFFFFFFFFF
        return int((h >> 33) % self.buckets)

    def push(self, key: int, value: float) -> tuple[int, float] | None:
        """Process one pair; returns an evicted (key, value) or None."""
        self.stats.input_pairs += 1
        b = self._bucket(key)
        row_keys = self.keys[b]
        hit = np.nonzero(row_keys == key)[0]
        if hit.size:  # aggregate (SUM)
            self.values[b, hit[0]] += value
            return None
        empty = np.nonzero(row_keys == -1)[0]
        if empty.size:  # insert
            self.keys[b, empty[0]] = key
            self.values[b, empty[0]] = value
            return None
        # collision: evict slot 0 (paper evicts the previously stored key),
        # shift remaining, insert the new pair in the last way.
        evicted = (int(row_keys[0]), float(self.values[b, 0]))
        self.keys[b, :-1] = self.keys[b, 1:]
        self.values[b, :-1] = self.values[b, 1:]
        self.keys[b, -1] = key
        self.values[b, -1] = value
        self.stats.output_pairs += 1
        return evicted

    def flush(self) -> list[tuple[int, float]]:
        """End-of-task flush (EoT) of all resident pairs."""
        out = []
        occ = self.keys != -1
        for b, w in zip(*np.nonzero(occ)):
            out.append((int(self.keys[b, w]), float(self.values[b, w])))
        self.stats.output_pairs += len(out)
        self.keys[:] = -1
        self.values[:] = 0.0
        return out


def simulate_node(
    keys: np.ndarray, values: np.ndarray | None, capacity: int, ways: int = 4
) -> tuple[NodeStats, list[tuple[int, float]]]:
    """Run one stream through one node; returns stats + full output stream."""
    node = HashAggregationNode(capacity, ways=ways)
    if values is None:
        values = np.ones_like(keys, dtype=np.float64)
    out: list[tuple[int, float]] = []
    for k, v in zip(keys.tolist(), values.tolist()):
        ev = node.push(int(k), float(v))
        if ev is not None:
            out.append(ev)
    out.extend(node.flush())
    return node.stats, out


def simulate_chain(
    keys: np.ndarray,
    values: np.ndarray | None,
    capacities: Sequence[int],
    ways: int = 4,
) -> tuple[float, list[NodeStats]]:
    """Multi-hop aggregation (paper Fig. 2b): a streamline of nodes.

    Each node's output stream (evictions + flush) feeds the next node.
    Returns (end-to-end reduction ratio, per-node stats).
    """
    if values is None:
        values = np.ones_like(keys, dtype=np.float64)
    stream = list(zip(keys.tolist(), values.tolist()))
    n_in = len(stream)
    stats: list[NodeStats] = []
    for cap in capacities:
        node = HashAggregationNode(cap, ways=ways)
        nxt: list[tuple[int, float]] = []
        for k, v in stream:
            ev = node.push(int(k), float(v))
            if ev is not None:
                nxt.append(ev)
        nxt.extend(node.flush())
        stats.append(node.stats)
        stream = nxt
    if n_in == 0:
        return 0.0, stats
    return 1.0 - len(stream) / n_in, stats


def merge_flows(flows: Iterable[np.ndarray]) -> np.ndarray:
    """Theorem 2.1 helper: interleave several flows into one (round-robin,
    matching a switch serving input ports fairly)."""
    arrs = [np.asarray(f) for f in flows]
    total = sum(a.size for a in arrs)
    out = np.empty(total, dtype=np.int64)
    idx = 0
    cursors = [0] * len(arrs)
    while idx < total:
        for i, a in enumerate(arrs):
            if cursors[i] < a.size:
                out[idx] = a[cursors[i]]
                cursors[i] += 1
                idx += 1
    return out


# ---------------------------------------------------------------------------
# Workload generators (paper §6.1: uniform and Zipf-0.99).
# ---------------------------------------------------------------------------


def uniform_keys(data_amount: int, key_variety: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, key_variety, size=data_amount, dtype=np.int64)


def zipf_keys(
    data_amount: int, key_variety: int, skew: float = 0.99, seed: int = 0
) -> np.ndarray:
    """Zipf(skew) over a finite key universe (paper uses skew 0.99)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, key_variety + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    return rng.choice(key_variety, size=data_amount, p=probs).astype(np.int64)


# ---------------------------------------------------------------------------
# TPU-domain byte model: what the tree schedule moves per link level.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeTrafficModel:
    """Bytes each topology level carries for one gradient exchange.

    ``flat``  — single all-reduce over all chips: every link level carries
                2·(w-1)/w · bytes (ring), including the scarce inter-pod level.
    ``tree``  — SwitchAgg schedule: reduce-scatter at level i happens on
                1/prod(upper fan-ins) of the bytes only after lower levels
                reduced; inter-pod traffic shrinks by the intra-pod fan-in.
    """

    grad_bytes: int
    fanins: tuple[int, ...]  # leaf -> root, e.g. (16, 2) = data axis, pod axis

    def flat_bytes_per_level(self) -> list[float]:
        w = math.prod(self.fanins)
        return [2.0 * (w - 1) / w * self.grad_bytes for _ in self.fanins]

    def tree_bytes_per_level(self) -> list[float]:
        out = []
        shard = float(self.grad_bytes)
        for i, f in enumerate(self.fanins):
            # reduce-scatter + all-gather at this level on the current shard
            out.append(2.0 * (f - 1) / f * shard)
            shard /= f
        return out

    def tree_reduction_at_root(self) -> float:
        """Traffic reduction on the topmost (scarcest) level vs flat."""
        flat = self.flat_bytes_per_level()[-1]
        tree = self.tree_bytes_per_level()[-1]
        return 1.0 - tree / flat
