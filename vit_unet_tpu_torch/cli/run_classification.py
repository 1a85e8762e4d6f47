"""Classification training CLI: the port's counterpart of
``vit_unet_tpu/cli/run_classification.py``, with the same flags, defaults
and recipe, on the card.

``python -m vit_unet_tpu_torch.cli.run_classification --input_folder DIR
--flash --dtype bfloat16`` trains the hierarchical ViT classifier on a
class-subdirectory image tree (PNG, JPEG or BMP files) through the port's
``Fitter``: a validation split of ``--val_fraction`` drawn from
``default_rng(42)``, categorical cross-entropy with label smoothing,
accuracy and F1, and the ramp-up / exponential-decay learning rate.  It
reloads the best checkpoint (lowest ``val_loss``), evaluates it, and prints
and returns the final metrics.  ``--device`` (default ``cuda``) is the
port's addition; with ``--flash`` re-attention runs the hand-written
kernels in eval and training, without it the plain PyTorch path.
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_folder", type=str, required=True,
                   help="root with one subdirectory per class")
    p.add_argument("--n_epochs", type=int, default=12)
    p.add_argument("--val_fraction", type=float, default=0.2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--im_size", type=int, default=224)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--depth_te", type=int, default=4)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--head_width", type=int, default=64)
    p.add_argument("--label_smoothing", type=float, default=0.05)
    p.add_argument("--start_lr", type=float, default=1e-5)
    p.add_argument("--max_lr", type=float, default=5e-5)
    p.add_argument("--rampup_epochs", type=int, default=5)
    p.add_argument("--exp_decay", type=float, default=0.8)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--checkpoint_dir", type=str, default="models")
    p.add_argument("--dtype", type=str, default="float32",
                   help="compute dtype, e.g. bfloat16 for the tensor cores")
    p.add_argument("--flash", action="store_true",
                   help="the hand-written re-attention kernels (eval and "
                        "training); without it the plain PyTorch path")
    p.add_argument("--data_parallel", action="store_true",
                   help="data parallelism over every rank: start one process "
                        "per card (torchrun --nproc_per_node=N -m ...); each "
                        "reads batch_size / N samples of every batch")
    p.add_argument("--log_jsonl", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to train on: cuda (the card) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from vit_unet_tpu_torch.data.augment import eval_transforms, train_transforms
    from vit_unet_tpu_torch.data.datasets import ClassificationDataset
    from vit_unet_tpu_torch.cli.run_denoising import _rank_loading
    from vit_unet_tpu_torch.data.loader import DataLoader
    from vit_unet_tpu_torch.models.vit_classifier import get_vit_classifier
    from vit_unet_tpu_torch.parallel.mesh import data_parallel_mesh, replica_count
    from vit_unet_tpu_torch.train.callbacks import JSONLLogger
    from vit_unet_tpu_torch.train.fitter import Fitter
    from vit_unet_tpu_torch.train.losses import categorical_crossentropy
    from vit_unet_tpu_torch.train.metrics import accuracy, f1
    from vit_unet_tpu_torch.train.schedules import (LearningRateScheduler,
                                                    rampup_exp_decay)
    from vit_unet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device) if args.data_parallel else None
    if mesh is not None:
        device = mesh.device
    replicas = replica_count(mesh) if mesh is not None else 1
    shard, per_rank = _rank_loading(mesh, args.batch_size)
    probe = ClassificationDataset.from_folder(args.input_folder,
                                              im_size=args.im_size)
    n = len(probe)
    if n == 0:
        raise SystemExit(f"no class images found under {args.input_folder!r}")
    num_classes = probe.num_classes
    print(f"found {n} images across {num_classes} classes: "
          f"{probe.class_names}")

    rng = np.random.default_rng(42)
    order = rng.permutation(n)
    n_val = max(1, int(n * args.val_fraction))
    val_idx, train_idx = order[:n_val], order[n_val:]

    train_ds = ClassificationDataset.from_folder(
        args.input_folder, im_size=args.im_size,
        transforms=train_transforms(args.im_size), indices=train_idx)
    val_ds = ClassificationDataset.from_folder(
        args.input_folder, im_size=args.im_size,
        transforms=eval_transforms(args.im_size), indices=val_idx)
    train_dl = DataLoader(train_ds, per_rank, shuffle=True,
                          num_workers=args.num_workers, **shard)
    val_dl = DataLoader(val_ds, per_rank, drop_remainder=False,
                        num_workers=args.num_workers, **shard)

    side = args.im_size // args.patch_size
    model = get_vit_classifier(
        device=device, depth=args.depth, depth_te=args.depth_te,
        linear_list=(args.head_width, num_classes), num_patches=side * side,
        patch_size=args.patch_size, hidden_dim=args.hidden_dim,
        num_heads=args.num_heads, use_flash=args.flash,
        flash_train=args.flash, dtype=args.dtype)

    def loss_fn(pred, target):
        return categorical_crossentropy(
            pred, target, label_smoothing=args.label_smoothing)
    loss_fn.__name__ = "ce"

    fitter = Fitter(model, learning_rate=args.start_lr, optimizer="adam",
                    loss=loss_fn, metrics=(accuracy, f1), mesh=mesh,
                    checkpoint_dir=args.checkpoint_dir,
                    monitor="val_loss", mode="min", device=device)
    callbacks = [LearningRateScheduler(rampup_exp_decay(
        start_lr=args.start_lr, max_lr=args.max_lr, min_lr=args.start_lr,
        rampup_epochs=args.rampup_epochs, exp_decay=args.exp_decay,
        replicas=replicas), verbose=True)]
    if args.log_jsonl and fitter.writes_checkpoints:
        callbacks.append(JSONLLogger(args.log_jsonl))

    fitter.fit(lambda: iter(train_dl), lambda: iter(val_dl),
               n_epochs=args.n_epochs, callbacks=callbacks)
    fitter.load()
    final = fitter.evaluate(lambda: iter(val_dl))
    print({k: round(float(v), 5) for k, v in final.items()})
    return final


if __name__ == "__main__":
    main()
