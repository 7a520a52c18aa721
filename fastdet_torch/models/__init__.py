from fastdet_torch.models.detector import Detector

__all__ = ["Detector"]
