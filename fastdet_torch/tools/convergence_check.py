"""End-to-end training convergence check on synthetic data
(counterpart of tools/convergence_check.py).

Generates a learnable detection task (solid coloured rectangles on noise
backgrounds, class = colour), trains a small model of the family from
torch's seeded initialisation with the full production train step, and
evaluates mAP@0.5 as training proceeds.  Passing bar (`converged`): the
last mAP over 0.5 and above the first.

    python -m fastdet_torch.tools.convergence_check [--steps 600]
        [--eval_every 150] [--batch 32] [--lr 0.002] [--bf16] [--chain K]
        [--model yolo-fastestv2|anchorfree] [--save out.npz]
        [--fused-backbone [--input-format nhwc|s2d_u8]] [--device cpu]

Prints the JAX tool's lines (`step N: mAP@0.5 = …`, `step N: loss=…
lr=…` every 50 steps, `trained …`, `AP curve: […]`, `saved …`,
`CONVERGENCE OK|FAILED`) and exits 0 or 1 as it does.  The data are the
JAX tool's draw for draw: the training stream from `RandomState(0)`, M =
8 labels an image, the fixed eval set of 64 images from `RandomState(99)`
in batches of 32, scored by the family's detect at conf 0.05 / iou 0.45.
The init is torch's from `seed`, so the curve is not JAX's; the bar is.

`--fused-backbone` trains the backbone's spans through B8 (ghost BN);
with `--input-format s2d_u8` the Trainer takes `pack_images_s2d` batches
and its stem runs B7.  The port has no chained step: `--chain K` runs K
steps one after another, under the JAX tool's rule for eval boundaries,
and prints the last one's metrics, as the JAX tool does.  `--save`
writes the JAX variable layout, which `fastdet.io.load_variables` reads.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from fastdet_torch import resolve_device
from fastdet_torch.config import Config
from fastdet_torch.eval.runner import evaluate
from fastdet_torch.io import save_npz_variables
from fastdet_torch.kernels.fused_infer import pack_images_s2d
from fastdet_torch.models.registry import get_family
from fastdet_torch.train.targets import pack_labels
from fastdet_torch.train.trainer import Trainer

SIZE = 128
MAX_LABELS = 8
EVAL_IMAGES = 64
EVAL_BATCH = 32
LOSS_EVERY = 50           # steps between the loss lines, as the JAX tool


def make_sample(rng, size=128, n_max=3):
    """One sample: (size, size, 3) uint8 and (n, 5) [cls, cx, cy, w, h]
    normalized labels (tools/convergence_check.py::make_sample, draw for
    draw)."""
    img = rng.randint(0, 80, (size, size, 3), np.uint8)
    n = rng.randint(1, n_max + 1)
    labels = []
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220)]
    for _ in range(n):
        cls = rng.randint(0, 3)
        w = rng.randint(size // 8, size // 2)
        h = rng.randint(size // 8, size // 2)
        x1 = rng.randint(0, size - w)
        y1 = rng.randint(0, size - h)
        img[y1:y1 + h, x1:x1 + w] = colors[cls]
        labels.append([cls, (x1 + w / 2) / size, (y1 + h / 2) / size,
                       w / size, h / size])
    return img, np.asarray(labels, np.float32)


def make_config(lr: float, batch: int) -> Config:
    """The JAX tool's task: 128², 3 classes, its 12 anchors."""
    return Config.from_dict({
        "classes": 3, "width": SIZE, "height": SIZE, "anchor_num": 3,
        "anchors": [20.0, 20.0, 36.0, 36.0, 52.0, 28.0,
                    28.0, 52.0, 56.0, 56.0, 80.0, 80.0],
        "learning_rate": lr, "steps": [10_000], "subdivisions": 1,
        "batch_size": batch, "epochs": 1})


def make_batch(rng, b: int):
    """b samples → (images (b, 128, 128, 3) uint8, labels (b, 8, 5),
    mask (b, 8)), numpy."""
    imgs, labs = zip(*(make_sample(rng, SIZE) for _ in range(b)))
    lab_arr, mask = pack_labels(list(labs), MAX_LABELS)
    return np.stack(imgs), lab_arr, mask


def eval_set():
    """The fixed eval set: 64 images from RandomState(99)."""
    return make_batch(np.random.RandomState(99), EVAL_IMAGES)


def eval_result(detect, images, labels, mask, device):
    """(P, R, mAP@0.5, F1) of `detect` on an eval set, in batches of 32
    (None where nothing was detected)."""
    def batches():
        for i in range(0, len(images), EVAL_BATCH):
            yield (torch.from_numpy(images[i:i + EVAL_BATCH]).to(device),
                   labels[i:i + EVAL_BATCH], mask[i:i + EVAL_BATCH])

    return evaluate(detect, batches(), (SIZE, SIZE))


def converged(aps: List[float]) -> bool:
    """The bar: the last mAP@0.5 over 0.5 and above the first."""
    return aps[-1] > 0.5 and aps[-1] > aps[0]


def run_convergence(steps: int = 600, eval_every: int = 150,
                    batch: int = 32, lr: float = 0.002, bf16: bool = False,
                    chain: int = 1, model: str = "yolo-fastestv2",
                    fused_backbone: bool = False,
                    input_format: str = "nhwc", device=None,
                    save: str = "", seed: int = 0,
                    record: Optional[dict] = None) -> List[float]:
    """Train `steps` steps of the synthetic task and evaluate every
    `eval_every` → the AP curve (step 0 first).  Prints the JAX tool's
    lines.  `record` (a dict), when given, receives the training loop's
    `seconds` and `img_s`, and the Trainer (`trainer`)."""
    if input_format != "nhwc" and not fused_backbone:
        raise ValueError("input_format='s2d_u8' takes fused_backbone=True")
    dev = resolve_device(device)
    cfg = make_config(lr, batch)
    dtype = torch.bfloat16 if bf16 else torch.float32
    # torch's init from `seed`, leaving the caller's generator as it was
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        family = get_family(model, cfg, dtype=dtype)
    # short warmup (5 "epochs" of 10 steps) so the run trains at full lr
    trainer = Trainer(family.model, cfg, steps_per_epoch=10,
                      compute_dtype=dtype, loss_fn=family.loss_fn,
                      fused_backbone=fused_backbone,
                      fused_input_format=input_format, device=dev)

    rng = np.random.RandomState(0)
    s2d = input_format == "s2d_u8"

    def train_step():
        images, labels, mask = make_batch(rng, batch)
        if s2d:
            images = pack_images_s2d(images)
        return trainer.step(torch.from_numpy(images), labels, mask)

    eval_imgs, eval_labels, eval_mask = eval_set()
    detect = family.build_detect_fn(conf_thres=0.05, iou_thres=0.45,
                                    device=dev)

    def ap_now():
        family.model.eval()        # the step leaves it in training mode
        res = eval_result(detect, eval_imgs, eval_labels, eval_mask, dev)
        return res[2] if res else 0.0

    aps = [ap_now()]
    print(f"step 0: mAP@0.5 = {aps[-1]:.4f}", flush=True)
    t0 = time.time()
    step = 0
    while step < steps:
        if chain > 1 and step + chain <= steps \
                and (step % eval_every) + chain <= eval_every:
            for _ in range(chain):        # no chained step yet: one by one
                metrics = train_step()
            step += chain
        else:
            metrics = train_step()
            step += 1
        if step % LOSS_EVERY == 0:
            print(f"step {step}: loss={float(metrics['total']):.3f} "
                  f"lr={float(metrics['lr']):.5f}", flush=True)
        if step % eval_every == 0:
            aps.append(ap_now())
            print(f"step {step}: mAP@0.5 = {aps[-1]:.4f}", flush=True)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"trained {steps} steps in {dt:.0f}s "
          f"({steps * batch / dt:.0f} img/s)", flush=True)
    print("AP curve:", [round(a, 4) for a in aps], flush=True)
    if save:
        save_npz_variables(trainer.model.state_dict(), save)
        print(f"saved {save}", flush=True)
    if record is not None:
        record.update(seconds=dt, img_s=steps * batch / dt, trainer=trainer)
    return aps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--eval_every", type=int, default=150)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.002)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute in the train step (parameters "
                         "stay f32) — validates bf16 training accuracy")
    ap.add_argument("--chain", type=int, default=1,
                    help="run K train steps between host checks (one "
                         "after another: the port has no chained step)")
    ap.add_argument("--model", type=str, default="yolo-fastestv2",
                    help="model family: yolo-fastestv2 | anchorfree")
    ap.add_argument("--save", type=str, default="",
                    help="save the final trained variables to this .npz "
                         "(the JAX variable layout)")
    ap.add_argument("--fused-backbone", action="store_true",
                    help="train the backbone's stride-1 spans through the "
                         "training span kernel (ghost BN)")
    ap.add_argument("--input-format", choices=("nhwc", "s2d_u8"),
                    default="nhwc",
                    help="the fused Trainer's input: s2d_u8 packs each "
                         "batch with pack_images_s2d and trains the stem "
                         "through the training stem kernel (needs "
                         "--fused-backbone)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.input_format != "nhwc" and not args.fused_backbone:
        ap.error("--input-format s2d_u8 needs --fused-backbone")

    aps = run_convergence(args.steps, args.eval_every, args.batch, args.lr,
                          args.bf16, args.chain, args.model,
                          args.fused_backbone, args.input_format,
                          args.device, args.save)
    ok = converged(aps)
    print("CONVERGENCE", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
