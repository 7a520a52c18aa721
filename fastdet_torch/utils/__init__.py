from fastdet_torch.utils.logging import MetricsLogger
from fastdet_torch.utils.profiling import StepTimer, summarize_model, trace

__all__ = ["MetricsLogger", "StepTimer", "summarize_model", "trace"]
