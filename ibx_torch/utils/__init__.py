"""March observability (the residual monitor and the profiler context,
`monitor`), the pytree-dataclass decorator (`pytree`) and the compiled
march (`graphs`: one step captured in a CUDA graph)."""
from .graphs import GraphedStep, Graphs, march_loop
from .monitor import ResidualMonitor, profile_trace
from .pytree import pytree_dataclass

__all__ = ["pytree_dataclass", "ResidualMonitor", "profile_trace",
           "GraphedStep", "Graphs", "march_loop"]
