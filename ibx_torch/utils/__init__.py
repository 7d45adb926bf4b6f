"""March observability: the residual monitor and the profiler context
(`monitor`). The JAX package's `pytree_dataclass` is not ported yet
(ROADMAP queue 1 item 10)."""
from .monitor import ResidualMonitor, profile_trace

__all__ = ["ResidualMonitor", "profile_trace"]
