from fastdet_torch.eval.metrics import (ap_per_class, average_precision,
                                        batch_statistics)
from fastdet_torch.eval.runner import evaluate

__all__ = ["ap_per_class", "average_precision", "batch_statistics",
           "evaluate"]
