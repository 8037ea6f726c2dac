"""Carry the JAX package's state across to the port.

This system has no weights; what crosses is aggregation state, given as
numpy arrays or as the JAX package's dataclasses and NamedTuples
(duck-typed: nothing here imports ``jax`` or ``repro``; arrays are read
through ``numpy.asarray``):

  * a resident FPE table (``table_keys``, ``table_values``);
  * a ``CompressorState`` residual;
  * a ``CascadePlan`` with its ``LevelSpec``s;
  * a ``dataplane.LevelState`` mid-stream (table, counters, the exact
    node's buffer), so a stream begun in JAX can end in the port.

Every helper takes ``device=`` (default ``"cuda"``; raises without a card
unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import as_tensor, resolve_device
from repro_torch.core import compressor, dataplane


def tensor(x, *, device: str | torch.device = "cuda") -> torch.Tensor:
    """numpy (or anything ``np.asarray`` reads, bf16 included) -> tensor."""
    return as_tensor(np.asarray(x), resolve_device(device))


def fpe_table(table_keys, table_values, *,
              device: str | torch.device = "cuda"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A resident FPE table ([cap] int32 keys, [cap, *lanes] values), in
    the flat layout ``kvagg.fpe_aggregate`` resumes from."""
    tk = tensor(table_keys, device=device).to(torch.int32)
    tv = tensor(table_values, device=device)
    if tk.dim() != 1 or tv.shape[:1] != tk.shape:
        raise ValueError(f"table shapes {tuple(tk.shape)} / "
                         f"{tuple(tv.shape)} are not [cap] / [cap, *lanes]")
    return tk, tv


def compressor_state(state, *, device: str | torch.device = "cuda"
                     ) -> compressor.CompressorState:
    """A ``CompressorState`` (or its bare residual array)."""
    residual = getattr(state, "residual", state)
    return compressor.CompressorState(residual=tensor(residual, device=device))


def level_spec(spec) -> dataplane.LevelSpec:
    return dataplane.LevelSpec(capacity=int(spec.capacity),
                               ways=int(spec.ways), bpe=bool(spec.bpe),
                               enabled=bool(spec.enabled))


def cascade_plan(plan) -> dataplane.CascadePlan:
    """A ``CascadePlan`` (duck-typed on ``op`` and ``levels``)."""
    return dataplane.CascadePlan(
        op=str(plan.op), levels=tuple(level_spec(s) for s in plan.levels))


def level_state(state, *, device: str | torch.device = "cuda"
                ) -> dataplane.LevelState:
    """A JAX ``dataplane.LevelState`` mid-stream -> the port's, with the
    resident table, counters and the exact node's buffer carried over, so
    the next ``ingest`` continues the same stream."""
    out = dataplane.LevelState(level_spec(state.spec), str(state.op),
                               batch_pad=state.batch_pad,
                               exact_stream=bool(state.exact_stream),
                               device=device)
    if state._tk is not None:
        out._tk, out._tv = fpe_table(state._tk, state._tv, device=device)
    if state._exact is not None:
        out._exact = [(tensor(k, device=device).to(torch.int32),
                       tensor(v, device=device)) for k, v in state._exact]
        out._exact_rows = int(state._exact_rows)
    if state._value_sample is not None:
        out._value_sample = tensor(state._value_sample, device=device)
    out.n_in = int(state.n_in)
    out.n_evict = int(state.n_evict)
    out.n_out = int(state.n_out)
    out._flushed = bool(state._flushed)
    return out
