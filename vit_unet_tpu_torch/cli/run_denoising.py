"""Restoration / segmentation training CLI: the port's counterpart of
``vit_unet_tpu/cli/run_denoising.py``, with the same flags, defaults and
task wiring, on the card.

``python -m vit_unet_tpu_torch.cli.run_denoising --task denoise
--input_folder DIR --flash --dtype bfloat16`` trains K folds of ViT-UNet on
a paired PNG folder through the port's ``Fitter``, reloads each fold's best
checkpoint, evaluates it, and prints and returns the headline metric's mean
and standard deviation over the folds as JSON.

``--task`` picks the folder layout and loss: ``denoise`` (clean/noisy),
``deblur`` (sharp/blur), ``derain`` (norain/rain) with MSE and PSNR/SSIM,
``segment`` (images/masks) with a one-channel logits head, soft-Dice + BCE
and Dice.  ``--device`` (default ``cuda``) is the port's addition; with
``--flash`` re-attention runs the hand-written kernels, without it the
plain PyTorch path on the same device.  Images must be PNG.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

#: per-task wiring: dataset class name, default loss, metrics, headline metric
TASKS = {
    "denoise": dict(dataset="DenoisingDataset", loss="mse",
                    metrics=("psnr", "ssim"), headline="psnr"),
    "deblur": dict(dataset="DeblurringDataset", loss="mse",
                   metrics=("psnr", "ssim"), headline="psnr"),
    "derain": dict(dataset="DerainingDataset", loss="mse",
                   metrics=("psnr", "ssim"), headline="psnr"),
    "segment": dict(dataset="SegmentationFolderDataset", loss="dice_bce",
                    metrics=("dice_logits",), headline="dice_logits"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", type=str, default="denoise",
                   choices=sorted(TASKS), help="which README task to train")
    p.add_argument("--input_folder", type=str, default="ssid",
                   help="root with clean/+noisy/ (denoise), sharp/+blur/ "
                        "(deblur), norain/+rain/ (derain) or images/+masks/ "
                        "(segment) subfolders of PNG files")
    p.add_argument("--n_epochs", type=int, default=100)
    p.add_argument("--folds", type=int, default=1,
                   help="number of CV folds to actually train (of 5)")
    p.add_argument("--model_string", type=str, default="lite",
                   choices=["lite", "base", "large", "notebook512"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--im_size", type=int, default=224)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--checkpoint_dir", type=str, default="models")
    p.add_argument("--loss", type=str, default=None,
                   help="override the task's default loss "
                        "(mse for restoration, dice_bce for segmentation)")
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
    p.add_argument("--bn_freeze_epochs", type=int, default=0,
                   help="frozen-BN warmup epochs before flipping to exact "
                        "batch-stats BN (see Fitter docstring)")
    p.add_argument("--bn_warmup", type=str, default="refold",
                   choices=("refold", "freeze", "track"),
                   help="what happens at the warmup flip: 'refold' is the "
                        "stat-matched function-preserving flip "
                        "(train/bn_refold.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to train on: cuda (the card) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from vit_unet_tpu_torch.data import datasets as ds_mod
    from vit_unet_tpu_torch.data.augment import eval_transforms, train_transforms
    from vit_unet_tpu_torch.data.datasets import kfold_split
    from vit_unet_tpu_torch.data.loader import DataLoader
    from vit_unet_tpu_torch.models.vit_unet import get_vit_unet
    from vit_unet_tpu_torch.parallel.mesh import data_parallel_mesh
    from vit_unet_tpu_torch.train.callbacks import JSONLLogger, ReduceLROnPlateau
    from vit_unet_tpu_torch.train.fitter import Fitter
    from vit_unet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    mesh = data_parallel_mesh(device) if args.data_parallel else None
    if mesh is not None:
        device = mesh.device
    shard, per_rank = _rank_loading(mesh, args.batch_size)
    task = TASKS[args.task]
    dataset_cls = getattr(ds_mod, task["dataset"])
    loss = args.loss or task["loss"]
    headline = task["headline"]

    probe = dataset_cls.from_folder(args.input_folder, im_size=args.im_size)
    n = len(probe)
    if n == 0:
        raise SystemExit(
            f"no sample pairs found under {args.input_folder!r} for task "
            f"{args.task!r} (see --input_folder help for the layout)")
    print(f"found {n} {args.task} pairs in {args.input_folder}")

    scores = []
    for fold, (train_idx, val_idx) in enumerate(kfold_split(n, 5)):
        if fold >= args.folds:
            break
        print(f"===== fold {fold} =====")
        train_ds = dataset_cls.from_folder(
            args.input_folder, im_size=args.im_size,
            transforms=train_transforms(args.im_size), indices=train_idx)
        val_ds = dataset_cls.from_folder(
            args.input_folder, im_size=args.im_size,
            transforms=eval_transforms(args.im_size), indices=val_idx)
        train_dl = DataLoader(train_ds, per_rank, shuffle=True,
                              num_workers=args.num_workers, **shard)
        # evaluation sees every sample (on a mesh, all but the last few that
        # do not share out over the ranks): no remainder dropping
        val_dl = DataLoader(val_ds, max(1, min(args.batch_size, len(val_ds))
                                        * per_rank // args.batch_size),
                            shuffle=False, drop_remainder=False,
                            num_workers=args.num_workers, **shard)

        overrides = {}
        if args.task == "segment":
            overrides["out_channels"] = 1   # logits head for the binary mask
        model = get_vit_unet(args.model_string, device=device,
                             im_size=args.im_size, dtype=args.dtype,
                             use_flash=args.flash, flash_train=args.flash,
                             **overrides)
        fitter = Fitter(model, learning_rate=args.lr, optimizer="adamw",
                        loss=loss, metrics=task["metrics"], mesh=mesh,
                        scale_lr_by_replicas=args.data_parallel,
                        checkpoint_dir=os.path.join(args.checkpoint_dir,
                                                    f"fold{fold}"),
                        bn_freeze_epochs=args.bn_freeze_epochs,
                        bn_warmup=args.bn_warmup, device=device)
        callbacks = [ReduceLROnPlateau()]
        if args.log_jsonl and fitter.writes_checkpoints:
            callbacks.append(JSONLLogger(args.log_jsonl))
        fitter.fit(lambda: iter(train_dl), lambda: iter(val_dl),
                   n_epochs=args.n_epochs, callbacks=callbacks)
        # reload the best checkpoint and evaluate it
        fitter.load()
        final = fitter.evaluate(lambda: iter(val_dl))
        print(f"fold {fold}: {final}")
        scores.append(final[f"val_{headline}"])

    key = "psnr" if headline == "psnr" else "dice"
    result = {f"{key}_mean": float(np.mean(scores)),
              f"{key}_std": float(np.std(scores))}
    print(json.dumps(result))
    return result


def _rank_loading(mesh, batch_size: int):
    """(DataLoader shard arguments, batch size a rank) of a data-parallel
    mesh: each data rank reads its own equal part of every batch."""
    if mesh is None:
        return {}, batch_size
    from vit_unet_tpu_torch.parallel.mesh import replica_count
    ranks = replica_count(mesh)
    if batch_size % ranks:
        raise SystemExit(f"--batch_size {batch_size} does not split over "
                         f"{ranks} data-parallel ranks")
    return (dict(shard_id=mesh.index("data"), num_shards=ranks),
            batch_size // ranks)


if __name__ == "__main__":
    main()
