from fastdet_torch.models.anchorfree import AnchorFreeDetector
from fastdet_torch.models.detector import Detector

__all__ = ["AnchorFreeDetector", "Detector"]
