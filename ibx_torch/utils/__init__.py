"""March observability (the residual monitor and the profiler context,
`monitor`) and the pytree-dataclass decorator (`pytree`)."""
from .monitor import ResidualMonitor, profile_trace
from .pytree import pytree_dataclass

__all__ = ["pytree_dataclass", "ResidualMonitor", "profile_trace"]
