"""Data-parallel denoising training on cards: the ``ViT_UNet_TF_TPU.ipynb``
recipe, the port's counterpart of ``examples/train_tpu_denoising.py`` (the
same flags, plus ``--device``).

The notebook's shape (cells 7-25): ``seed_everything``, the mesh (pure data
parallelism, one process a card), the learning rate times the replicas
(cell 19's ``Adam(lr * REPLICAS)``), TFRecord input streamed off the
shards (every rank reads them alike and takes its own batches of each
round), ``ReduceLROnPlateau`` /
``EarlyStopping``, ``Fitter.fit``, the best checkpoint reloaded, then
cell 25's three PSNR probes (noisy-vs-clean, pred-vs-clean,
pred-vs-noisy).

On cards:    torchrun --nproc_per_node=N -m \\
                 vit_unet_tpu_torch.cli.train_denoising \\
                 --tfrec "tfrec/ssid_fold_0_*" --epochs 10 --per_replica_batch 8
On the CPU:  add --device cpu (gloo between the processes).
"""
from __future__ import annotations

import argparse
import glob


class _RankBatches:
    """This data rank's batches of a stream every rank reads alike (the
    same shuffle seed): batch i of each epoch where i % replicas is the
    rank, ``rounds`` of them, so every rank takes as many steps."""

    def __init__(self, stream, rank: int, replicas: int, rounds: int):
        self.stream, self.rank, self.replicas, self.rounds = (
            stream, rank, replicas, rounds)

    def __iter__(self):
        for i, batch in enumerate(self.stream):
            if i >= self.rounds * self.replicas:
                return
            if i % self.replicas == self.rank:
                yield batch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tfrec", required=True, help="glob of TFRecord shards")
    p.add_argument("--shape", type=int, nargs=3, default=(128, 128, 3),
                   help="stored image H W C")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--per_replica_batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-6,
                   help="base LR; scaled by replica count like the notebook")
    p.add_argument("--model", default="base")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--flash", action="store_true",
                   help="the re-attention kernels (training too)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from vit_unet_tpu_torch.data.loader import TFRecordStream
    from vit_unet_tpu_torch.data.tfrecord import count_data_items
    from vit_unet_tpu_torch.models.vit_unet import get_vit_unet
    from vit_unet_tpu_torch.parallel.mesh import (
        create_mesh, initialize_distributed, replica_count)
    from vit_unet_tpu_torch.train.callbacks import EarlyStopping, ReduceLROnPlateau
    from vit_unet_tpu_torch.train.fitter import Fitter
    from vit_unet_tpu_torch.train.metrics import psnr
    from vit_unet_tpu_torch.utils.seeding import seed_everything

    device = initialize_distributed(device=args.device)
    seed_everything(42, device)
    mesh = create_mesh(model_parallel=1, device=device)      # pure DP
    replicas = replica_count(mesh)
    lead = mesh.rank == 0
    if lead:
        print(f"replicas: {replicas}  global batch: "
              f"{args.per_replica_batch * replicas}")

    paths = sorted(glob.glob(args.tfrec))
    if not paths:
        raise FileNotFoundError(f"no shards match {args.tfrec!r}")
    shape = tuple(args.shape)
    rounds = count_data_items(paths) // (args.per_replica_batch * replicas)
    if rounds == 0:
        raise ValueError("fewer records than one global batch")
    train = _RankBatches(TFRecordStream(paths, shape, args.per_replica_batch,
                                        shuffle_buffer=256),
                         mesh.index("data"), replicas, rounds)
    val = _RankBatches(TFRecordStream(paths, shape, args.per_replica_batch),
                       mesh.index("data"), replicas, rounds)

    # train at the stored resolution (targets stay at the stored size, as
    # the TF notebook trains 128² natively)
    h, w, _ = shape
    if h != w:
        raise ValueError("stored images must be square")
    model = get_vit_unet(args.model, device=device, im_size=h, dtype=args.dtype,
                         use_flash=args.flash, flash_train=args.flash)
    fitter = Fitter(model, learning_rate=args.lr, optimizer="adam", loss="mse",
                    metrics=("psnr",), mesh=mesh, scale_lr_by_replicas=True,
                    device=device)                      # Adam(lr * REPLICAS)
    fitter.fit(train, val, n_epochs=args.epochs, save_last=True,
               callbacks=[ReduceLROnPlateau(patience=1, factor=0.5),
                          EarlyStopping(patience=4)])
    fitter.load()

    # the notebook's three-way PSNR probe (cell 25)
    sample = next(iter(val))
    pred = fitter.predict(sample["x"]).float()
    x = torch.as_tensor(sample["x"], device=device).float()
    y = torch.as_tensor(sample["y"], device=device).float()
    probes = {"noisy_vs_clean": float(psnr(x, y)), "pred_vs_clean": float(psnr(pred, y)),
              "pred_vs_noisy": float(psnr(pred, x))}
    if lead:
        print(f"PSNR noisy-vs-clean: {probes['noisy_vs_clean']:.2f} dB")
        print(f"PSNR pred-vs-clean:  {probes['pred_vs_clean']:.2f} dB")
        print(f"PSNR pred-vs-noisy:  {probes['pred_vs_noisy']:.2f} dB")
    return probes


if __name__ == "__main__":
    main()
