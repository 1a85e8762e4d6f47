#!/usr/bin/env python3
"""The step of ``HViTUNetTF``'s re-attention variant (``chip_smoke.py``
phase 7d: full width, 128², bf16, b64, exact BN, 3 steps) on the card, with
its device busy share, for the tree at ``--root`` (default: this checkout),
through that tree's own ``chip_smoke.py``.  To compare two trees, unpack the
other under ``build/`` (``git archive``) and run them in turns in one call:

    python tools/torch_variant_busy.py --root build/parent --build-only &
    python tools/torch_variant_busy.py --build-only; wait
    for r in build/parent . . build/parent; do
        python tools/torch_variant_busy.py --root $r; done

Each run prints the tree, the card's name and power limit, the median step
time and ``device time per ... (busy X%)``.
"""
from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--build-only", action="store_true",
                   help="build the tree's kernels and stop")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as C
    if not torch.cuda.is_available():
        print("torch_variant_busy: no CUDA device", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.abspath(C.__file__)) != root:
        raise RuntimeError(f"imported {C.__file__}, not the tree at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vit_unet_tpu_torch.kernels import _build
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(_build.build, (C.EVAL_SOURCE, C.TRAIN_SOURCE)))
    if args.build_only:
        return 0
    print(f"== tree {root} [{C.card_line()}]")
    C.tf_variant()
    return 0


if __name__ == "__main__":
    sys.exit(main())
