from heat_tpu_torch.utils.profiling import PhaseTimer, performance_breakdown
from heat_tpu_torch.utils.logging import get_logger, MetricsLogger

__all__ = [
    "PhaseTimer",
    "performance_breakdown",
    "get_logger",
    "MetricsLogger",
]
