"""Long-context training: sequence parallelism x data parallelism, the
port's counterpart of ``examples/train_sp_longcontext.py`` (same flags,
plus ``--device``).

ViT-UNet trains with the token axis of every level of at least
``--sp_min_tokens`` tokens split over the mesh's ``model`` axis (each rank
runs its query rows against the all-gathered K/V on the kernels:
``parallel/sequence.py``) and the parameters the partition rules name split
over it too (FeedForward, ``proj``, the position embedding:
``parallel/partition.py``, as the JAX mesh step splits them), while the
batch is split over ``data``.  One process per rank; the mesh is
``world / model_parallel`` x ``model_parallel``.

On cards:    torchrun --nproc_per_node=2 -m \\
                 vit_unet_tpu_torch.cli.train_sp_longcontext --im_size 512
On the CPU:  torchrun --nproc_per_node=2 -m \\
                 vit_unet_tpu_torch.cli.train_sp_longcontext --device cpu \\
                 --im_size 128 --patch_size 16 --steps 2 --batch 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--im_size", type=int, default=512)
    p.add_argument("--patch_size", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=48)
    p.add_argument("--model_parallel", type=int, default=2,
                   help="sequence shards (the mesh 'model' axis)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--sp_min_tokens", type=int, default=1024,
                   help="only levels with >= this many tokens shard")
    p.add_argument("--exact_bn", action="store_true",
                   help="exact batch-stats BN (default: frozen-BN fast mode)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (one card a rank) or cpu")
    return p


def main(argv=None) -> list[float]:
    args = build_parser().parse_args(argv)

    from vit_unet_tpu_torch.models.vit_unet import ViTUNet, ViTUNetConfig
    from vit_unet_tpu_torch.parallel.mesh import create_mesh, initialize_distributed
    from vit_unet_tpu_torch.parallel.partition import placements
    from vit_unet_tpu_torch.parallel.train_step import (
        TrainState, adamw, build_step_functions)
    from vit_unet_tpu_torch.train.losses import mse

    device = initialize_distributed(device=args.device)
    mesh = create_mesh(model_parallel=args.model_parallel, device=device)
    lead = mesh.rank == 0
    if lead:
        print(f"mesh: {mesh.shape} on {device}")

    cfg = ViTUNetConfig(
        depth=2, depth_te=1, size_bottleneck=1, preprocessing="conv",
        im_size=args.im_size, patch_size=args.patch_size, num_channels=3,
        hidden_dim=args.hidden_dim, num_heads=4,
        attn_drop=0.0, proj_drop=0.0, linear_drop=0.0,
        use_flash=True, flash_train=True,
        flash_frozen_bn=not args.exact_bn,
        sequence_parallel=True, sp_min_tokens=args.sp_min_tokens)
    fine_tokens = cfg.level_geometry(cfg.depth)["num_patches"]
    if lead:
        print(f"finest level: {fine_tokens} tokens, "
              f"{fine_tokens // args.model_parallel} rows/shard")

    model = ViTUNet(cfg, mesh=mesh).init_weights(
        torch.Generator().manual_seed(0)).to(device)
    opt = adamw(model, 3e-4)
    rng = np.random.default_rng(0)
    shape = (args.batch, 3, args.im_size, args.im_size)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    batch = {"x": x, "y": x * 0.8}           # the whole batch on every rank
    state = TrainState.create(model=model, optimizer=opt, seed=1)
    nbytes = lambda: sum(p.numel() * p.element_size() for p in model.parameters())
    whole = nbytes()
    steps = build_step_functions(model, opt, mse, mesh=mesh)
    if lead:
        print(f"parameters on rank 0: {nbytes()} of {whole} bytes "
              f"({len(placements(model))} tensors split over model)")

    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, m = steps.train_step(state, batch)
        loss = float(m["loss"])                 # host copy = step barrier
        dt = time.perf_counter() - t0
        losses.append(loss)
        if lead:
            tag = " (first: builds and warms up)" if i == 0 else ""
            print(f"step {i}: loss {loss:.4f}  {dt * 1e3:8.1f} ms{tag}")
    return losses


if __name__ == "__main__":
    main()
