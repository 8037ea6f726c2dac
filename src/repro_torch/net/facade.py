"""``repro_torch.net.simulate`` — the front door of the packet simulator
(DESIGN.md §13), ported to torch (counterpart of ``repro/net/facade.py``).

It dispatches on what it is handed:

===========================  =============================================
``spec_or_plan``             runs as
===========================  =============================================
``sim.JobSpec``              one job (``keys``/``values`` ride the spec)
``[JobSpec, ...]``           a lockstep batch (+ mid-run ``admissions``)
===========================  =============================================

``engine=`` overrides ``NetConfig.engine`` without rebuilding the config
("node" or "vectorized" — results are bit-identical either way), ``cfg=``
replaces it, and ``device=`` (default ``"cuda"``) says where the table
work runs.

Not ported yet, and refused with ``NotImplementedError`` rather than run
some other way: a ``planner.JobPlan`` or a batch of them and a
``planner.FatTreeTopology`` (they need ``core.planner``), and
``faults=`` (the fault plane of ``runtime.fault_tolerance``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch import resolve_device
from . import sim as sim_lib

__all__ = ["simulate"]


def _is_job_plan(x) -> bool:
    """Duck-typed ``planner.JobPlan`` (carries configure + tree)."""
    return hasattr(x, "configure") and hasattr(x, "tree")


def _is_fat_tree(x) -> bool:
    """Duck-typed ``planner.FatTreeTopology``."""
    return hasattr(x, "tier_switches") and hasattr(x, "link_tiers")


def _spec_with(spec: sim_lib.JobSpec, cfg, engine) -> sim_lib.JobSpec:
    if cfg is not None:
        spec = dataclasses.replace(spec, cfg=cfg)
    if engine is not None:
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg or sim_lib.NetConfig(), engine=engine))
    return spec


def simulate(spec_or_plan, keys=None, values=None, *, faults=None,
             engine=None, cfg=None, admissions=None,
             device: str | torch.device = "cuda"):
    """Run a job or a lockstep batch of jobs over the emulated network.

    Returns a ``SimResult`` (one ``JobSpec``) or a ``list[SimResult]`` (a
    sequence of them, then the ``admissions`` in order).  See the module
    docstring for what is not ported yet.
    """
    x = spec_or_plan
    is_batch = (isinstance(x, Sequence)
                and not isinstance(x, (str, bytes)))
    if faults is not None:
        raise NotImplementedError(
            "faults= needs the fault plane (runtime.fault_tolerance and "
            "the sim's epoch-restart driver), not ported yet")
    if _is_fat_tree(x) or _is_job_plan(x) or (
            is_batch and any(_is_job_plan(p) for p in x)):
        raise NotImplementedError(
            "fat-tree and JobPlan inputs need core.planner, not ported yet")
    if admissions is not None and not is_batch:
        raise TypeError("admissions= applies to a batch (a sequence of "
                        "JobSpec) — single-job forms have no lockstep to "
                        "join mid-run")
    if keys is not None or values is not None:
        raise TypeError("a JobSpec carries its own keys/values")
    dev = resolve_device(device)
    if isinstance(x, sim_lib.JobSpec):
        return sim_lib._simulate_jobs([_spec_with(x, cfg, engine)],
                                      device=dev)[0]
    if is_batch:
        items = list(x)
        if not all(isinstance(s, sim_lib.JobSpec) for s in items):
            raise TypeError("simulate() batch must be all JobSpec")
        adm = [(step, _spec_with(s, cfg, engine))
               for step, s in (admissions or ())]
        return sim_lib._simulate_jobs(
            [_spec_with(s, cfg, engine) for s in items], admissions=adm,
            device=dev)
    raise TypeError(f"simulate() cannot dispatch on "
                    f"{type(spec_or_plan).__name__!r}; expected JobSpec "
                    "or a sequence of JobSpec")
