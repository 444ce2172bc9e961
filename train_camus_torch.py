"""CAMUS-style 4-class segmentation training on an NVIDIA GPU (the port of
`train_camus.py`, the legacy harness).

Exercises the CAMUS-era surface end to end: dict-pipeline transforms
(rotation about the apex, intensity windowing), the generic
`run_training`/`run_validation` loops with gradient accumulation, per-name
Dice validation (with the LVepi union), and optionally the ACNN shape-prior
regularizer. The reference ships this harness without its CAMUS network,
so `SegNet`, a compact encoder-decoder, is echoflow's flax SegNet as an
`nn.Module` (flax's SAME padding). CAMUS data is access-gated, so
`--synthetic` generates 4-class (BG/LV/Myo/LA) phantoms.

    python train_camus_torch.py --synthetic --epochs 3 [--device cuda|cpu]
    python train_camus_torch.py --data /path/CAMUS --epochs 30 --acnn

The networks are initialized on the CPU from `--seed`, so a run on the card
and one on the CPU start from the same weights.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn as nn

from echoflow_torch.models.flax_layers import SameConv2d, SameConvTranspose2d


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="CAMUS 4-class segmentation training "
                                             "(echoflow_torch)")
    ap.add_argument("--data", type=str, default=None, help="CAMUS root (patientNNNN dirs)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--effective-batchsize", type=int, default=4,
                    help="gradient-accumulation factor (reference CAMUS config: 16)")
    ap.add_argument("--lr", type=float, default=2e-3)   # CAMUS_CONFIG default
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--acnn", action="store_true", help="add the AE shape prior")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def make_camus_phantom(h, w, rng):
    """4-class phantom: LV cavity (1) inside a myocardial ring (2), atrium
    (3) below, speckle background (echoflow's, draw for draw)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = h * 0.42 + rng.randn() * 2, w * 0.5 + rng.randn() * 2
    r = h * rng.uniform(0.16, 0.22)
    lv = ((yy - cy) / (1.5 * r)) ** 2 + ((xx - cx) / r) ** 2 <= 1.0
    epi = ((yy - cy) / (1.5 * r + 4)) ** 2 + ((xx - cx) / (r + 4)) ** 2 <= 1.0
    la = (((yy - (cy + 1.9 * r)) / (0.7 * r)) ** 2 + ((xx - cx) / (0.8 * r)) ** 2) <= 1.0
    label = np.zeros((h, w), np.int32)
    label[epi] = 2
    label[lv] = 1
    label[la & (label == 0)] = 3
    img = 0.25 + 0.12 * (label == 2) + 0.02 * (label == 1) + 0.08 * (label == 3)
    img = img + 0.04 * rng.randn(h, w)
    return {"images": img.astype(np.float32)[None], "labels": label}


class SegNet(nn.Module):
    """(N, 1, H, W) -> (N, C, H, W) logits: three SAME convs (16, 32 and 64
    channels, the last two stride 2), two stride-2 transposed convs with
    skip concatenations, a 1x1 head; ReLU between."""

    FLAX_LAYERS = (("Conv_0", "enc1"), ("Conv_1", "enc2"), ("Conv_2", "enc3"),
                   ("ConvTranspose_0", "dec2"), ("ConvTranspose_1", "dec1"),
                   ("Conv_3", "head"))

    def __init__(self, num_classes: int = 4):
        super().__init__()
        self.enc1 = SameConv2d(1, 16, 3)
        self.enc2 = SameConv2d(16, 32, 3, 2)
        self.enc3 = SameConv2d(32, 64, 3, 2)
        self.dec2 = SameConvTranspose2d(64, 32, 3, 2)
        self.dec1 = SameConvTranspose2d(64, 16, 3, 2)
        self.head = SameConv2d(32, num_classes, 1)

    def forward(self, x):
        e1 = torch.relu(self.enc1(x))
        e2 = torch.relu(self.enc2(e1))
        e3 = torch.relu(self.enc3(e2))
        d2 = torch.relu(self.dec2(e3))
        d1 = torch.relu(self.dec1(torch.cat([d2, e2], dim=1)))
        return self.head(torch.cat([d1, e1], dim=1))


def build_model(num_classes=4, seed=0) -> SegNet:
    """A SegNet initialized on the CPU from `seed`."""
    torch.manual_seed(seed)
    return SegNet(num_classes)


def load_records(args, rng):
    """The training records: phantoms, or the ED frames of a CAMUS root."""
    hw = args.image_size
    if args.synthetic or not args.data:
        return [make_camus_phantom(hw, hw, rng) for _ in range(args.samples)]
    from echoflow_torch.data.transforms import make_camus_echo_dataset
    from echoflow_torch.utils.echo_io import readTransformResizeImage

    records = []
    for views in make_camus_echo_dataset(args.data).values():
        for files in views.values():
            img = readTransformResizeImage(files["ED"], (hw, hw))
            lab = readTransformResizeImage(files["ED_gt"], (hw, hw), outtype=np.int64)
            records.append({"images": img.astype(np.float32),
                            "labels": lab[0].astype(np.int32)})
    return records


def main(argv=None):
    """Returns (model, Dice by name, losses): the per-epoch training losses,
    then the validation loss."""
    args = parse_args(argv)
    from echoflow_torch.data.transforms import RotateImagesAndLabels, WindowImagesAndLabels
    from echoflow_torch.train.generic import (ShapeAutoencoder, TransformDataset,
                                              batch_iterator, run_training,
                                              run_training_acnn, run_validation)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("train_camus_torch: no CUDA device (pass --device cpu)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(args.seed)
    hw = args.image_size
    records = load_records(args, rng)
    aug = [WindowImagesAndLabels((0.7, 1.0), rng=rng),
           RotateImagesAndLabels(scale=8.0, rng=rng)]
    ds = TransformDataset(records, augment_transforms=aug)

    model = build_model(seed=args.seed).to(device)
    ae = None
    if args.acnn:
        torch.manual_seed(args.seed + 1)
        ae = ShapeAutoencoder(num_classes=4, latent_dim=32, hidden=8,
                              image_size=(hw, hw)).to(device)

    optimizer = None
    losses = []
    for epoch in range(args.epochs):
        it = batch_iterator(ds, args.batch_size, rng=np.random.RandomState(epoch))
        if args.acnn:
            model, _, avg, _ = run_training_acnn(
                model, ae, it, effective_batchsize=args.effective_batchsize,
                learning_rate=args.lr, keys=("images", "labels"))
        else:
            model, optimizer, avg, _ = run_training(
                model, it, effective_batchsize=args.effective_batchsize,
                optimizer=optimizer, learning_rate=args.lr, weight_decay=1e-5,
                keys=("images", "labels"))
        losses.append(avg)
        print(f"epoch {epoch}: train loss {avg:.4f}")

    avg, _, dices = run_validation(model, batch_iterator(ds, args.batch_size, shuffle=False),
                                   keys=("images", "labels"), do_dice=True)
    losses.append(avg)
    summary = {k: round(float(np.mean(v)), 3) for k, v in dices.items()}
    print(f"validation loss {avg:.4f} dice-by-name {summary}")
    return model, summary, losses


if __name__ == "__main__":
    main()
