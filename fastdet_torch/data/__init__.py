"""Darknet-format data for the port (imports cv2: keep it off the card's
path; see dataset.py)."""

from fastdet_torch.data.dataset import DarknetDataset, default_augment
from fastdet_torch.data.loader import DataLoader

__all__ = ["DarknetDataset", "default_augment", "DataLoader"]
