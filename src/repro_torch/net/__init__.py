"""Network layer of the port (counterpart of ``repro.net``): packet-level
network emulation and the job-completion-time simulator (DESIGN.md §7).

Submodules:
  wire      — MTU framing of KV records; THE byte-size constants
  links     — per-link bandwidth / latency / FIFO-queue model
  transport — seeded loss injection + go-back-N retransmit
  schema    — unified sim report schema + metrics publishing
  sim       — discrete-event engine: mappers -> switch cascade -> reducer
  vsim      — vectorized tier engine behind ``NetConfig.engine``
  facade    — ``simulate``, the public entry point

``wire``, ``links`` and ``transport`` are copies of the JAX package's
numpy modules.  Submodules load lazily, as in the JAX package:
``core.reduction_model`` imports ``net.wire`` while ``net.sim`` imports
``core.dataplane``.  ``simulate`` is re-exported the same lazy way.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("wire", "links", "transport", "schema", "sim", "vsim",
               "facade")

__all__ = [*_SUBMODULES, "simulate"]


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name == "simulate":
        return importlib.import_module(f"{__name__}.facade").simulate
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES) | {"simulate"})
