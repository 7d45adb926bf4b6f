"""March observability (the residual monitor, the program's spans and
counters and the profiler context, `monitor`), the pytree-dataclass
decorator (`pytree`) and the compiled march (`graphs`: one step captured
in a CUDA graph)."""
from .graphs import GraphedStep, Graphs, graphed_call, march_loop
from .monitor import (ResidualMonitor, count, device_span, profile_trace,
                      records, span, tracing)
from .pytree import pytree_dataclass

__all__ = ["pytree_dataclass", "ResidualMonitor", "profile_trace",
           "tracing", "span", "device_span", "count", "records",
           "GraphedStep", "Graphs", "graphed_call", "march_loop"]
