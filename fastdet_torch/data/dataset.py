"""Darknet-format dataset: image list txt + per-image label txt (the
port's own copy of fastdet/data/dataset.py).

Capability parity with the reference Yolo-FastestV2 loader (its
utils/datasets.py:77-132):
  * the list file has one image path per line; every path must exist and
    have extension ∈ {bmp, jpg, jpeg, png} (validated at init)
  * the label file lives at `<image path up to first dot>.txt`, one
    `cls cx cy w h` row per object, normalized coordinates
  * images are cv2.imread BGR, plain INTER_LINEAR resize to (W,H) —
    deliberately NOT letterboxed (datasets.py:107); mAP depends on this
  * images stay HWC uint8; /255 normalisation happens on the device
    (`ops.postprocess.build_detect_fn`), or the host packs them into the
    s2d(4) layout for the fused forward

cv2 is imported here at module level.  The card's machine has no cv2, so
nothing on the serving path or in `chip_smoke.py` imports this package;
the eval CLI imports it inside `main`.

The reference ships four augmentations but only contrast/brightness is
active in its pipeline (datasets.py:63-68); all four are provided here
with the same default wiring.
"""

from __future__ import annotations

import os
import random
from typing import Callable, List, Optional, Tuple

import cv2
import numpy as np

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png")


# ---------------- augmentations ----------------

def contrast_and_brightness(img: np.ndarray, rng: random.Random) -> np.ndarray:
    alpha = rng.uniform(0.25, 1.75)
    beta = rng.uniform(0.25, 1.75)
    blank = np.zeros(img.shape, img.dtype)
    return cv2.addWeighted(img, alpha, blank, 1 - alpha, beta)


def motion_blur(img: np.ndarray, rng: random.Random) -> np.ndarray:
    if rng.randint(1, 2) != 1:
        return img
    degree = rng.randint(2, 3)
    angle = rng.uniform(-360, 360)
    M = cv2.getRotationMatrix2D((degree / 2, degree / 2), angle, 1)
    kernel = cv2.warpAffine(np.diag(np.ones(degree)), M, (degree, degree))
    kernel = kernel / degree
    blurred = cv2.filter2D(img, -1, kernel)
    cv2.normalize(blurred, blurred, 0, 255, cv2.NORM_MINMAX)
    return np.asarray(blurred, np.uint8)


def augment_hsv(img: np.ndarray, rng: random.Random,
                hgain: float = 0.0138, sgain: float = 0.678,
                vgain: float = 0.36) -> np.ndarray:
    r = np.asarray([rng.uniform(-1, 1) for _ in range(3)]) \
        * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def random_resize(img: np.ndarray, rng: random.Random) -> np.ndarray:
    h, w, _ = img.shape
    rw = int(w * rng.uniform(0.8, 1))
    rh = int(h * rng.uniform(0.8, 1))
    img = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LINEAR)
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


def default_augment(img: np.ndarray, rng: random.Random) -> np.ndarray:
    """The reference's active augmentation set (contrast/brightness only)."""
    return contrast_and_brightness(img, rng)


# ---------------- dataset ----------------

class DarknetDataset:
    def __init__(self, list_path: str, img_width: int = 352,
                 img_height: int = 352,
                 augment: Optional[Callable] = None,
                 seed: int = 0):
        assert os.path.exists(list_path), \
            f"dataset list file not found: {list_path}"
        self.width = img_width
        self.height = img_height
        self.augment = augment
        self.seed = seed
        self._epoch = 0

        self.items: List[str] = []
        with open(list_path, "r") as f:
            for line in f.readlines():
                path = line.strip()
                if not path:
                    continue
                if not os.path.exists(path):
                    raise FileNotFoundError(f"{path} does not exist")
                ext = path.split(".")[-1].lower()
                if ext not in IMG_FORMATS:
                    raise ValueError(f"unsupported image type: {path}")
                self.items.append(path)

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        """Key the augmentation RNG on the epoch (see __getitem__)."""
        self._epoch = int(epoch)

    @staticmethod
    def label_path(img_path: str) -> str:
        # reference convention: everything up to the FIRST dot + .txt
        return img_path.split(".")[0] + ".txt"

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (image HWC uint8 BGR at (H,W), labels (n,5) float32)."""
        img_path = self.items[index]
        img = cv2.imread(img_path)
        if img is None:
            raise IOError(f"failed to read image: {img_path}")
        img = cv2.resize(img, (self.width, self.height),
                         interpolation=cv2.INTER_LINEAR)
        if self.augment is not None:
            # per-(seed, epoch, index) RNG: thread-safe (loader workers
            # share no stream) and deterministic across --resume
            rng = random.Random(
                (self.seed * 1000003 + self._epoch) * 1000003 + index)
            img = self.augment(img, rng)

        lpath = self.label_path(img_path)
        if not os.path.exists(lpath):
            raise FileNotFoundError(f"label file missing: {lpath}")
        rows = []
        with open(lpath, "r") as f:
            for line in f.readlines():
                parts = line.strip().split(" ")
                if len(parts) >= 5:
                    rows.append([float(v) for v in parts[:5]])
        labels = np.asarray(rows, np.float32).reshape(-1, 5)
        return img, labels
