"""Export a trained model for serving and run inference from the artifact:
the port's counterpart of ``examples/serve_model.py`` (the same flags,
plus ``--device``).

The eval forward is recorded with ``torch.export`` into
``<out>/program.pt2`` with its weights (``serving.export_predictor``), so
the serving process needs no model code; it is loaded back onto the device
(``serving.load_predictor``) and run on a random batch.  ``--checkpoint``
is a ``Fitter.save`` file (``<dir>/<name>.pt``), where the JAX script
reads an orbax directory.

    python -m vit_unet_tpu_torch.cli.serve_model \\
        --checkpoint models/best-checkpoint.pt --model lite --out exported/
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="lite")
    p.add_argument("--checkpoint", default=None,
                   help="Fitter.save checkpoint file; random init if omitted")
    p.add_argument("--out", default="exported")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--flash", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vit_unet_tpu_torch.models.vit_unet import get_vit_unet
    from vit_unet_tpu_torch.serving import export_predictor, load_predictor

    model = get_vit_unet(args.model, device=args.device, use_flash=args.flash)
    cfg = model.config
    if args.checkpoint:
        ck = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(ck["model"])

    export_predictor(model, args.out, batch_size=args.batch_size)
    print(f"exported to {args.out}")

    fn = load_predictor(args.out, device=args.device)
    x = np.random.default_rng(0).normal(
        size=(args.batch_size, 3, cfg.im_size, cfg.im_size)).astype(np.float32)
    out = np.asarray(fn(x))
    print(f"served inference OK: {x.shape} -> {out.shape}")
    return out


if __name__ == "__main__":
    main()
