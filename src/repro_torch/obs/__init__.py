"""repro_torch.obs — observability: span tracing, metrics, dashboards.

DESIGN.md §11.  Stdlib-only, so every layer of the port can import it without
cycles.  A copy of ``repro/obs/__init__.py``; the report module waits
for a later slice.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    InstrumentedStep,
    MetricsRegistry,
    get_registry,
    instrument_step,
    scoped,
    set_registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer,
    disable,
    enable,
    get_tracer,
    scoped_tracer,
    set_tracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "InstrumentedStep", "MetricsRegistry",
    "get_registry", "instrument_step", "scoped", "set_registry",
    "Tracer", "disable", "enable", "get_tracer", "scoped_tracer",
    "set_tracer",
]
