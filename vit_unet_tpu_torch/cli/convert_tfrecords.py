"""Convert paired clean/noisy images into fold-sharded TFRecords: the
port's counterpart of ``examples/convert_tfrecords.py`` (the same flags).

Mirrors ``Convert_tfrecords.ipynb`` (cells 0-3): pair ``{root}/clean`` and
``{root}/noisy`` by sorted order, KFold(5, seed=42), write
``ssid_fold_{k}_{idx}-{count}.tfrec`` shards capped at ``--max_mb`` with the
item count in the filename (the contract ``count_data_items`` reads).
Images are read by the port's own ``data/image_io.py`` (PNG, BMP, JPEG; no
``cv2``) as RGB, noisy as ``x`` and clean as ``y``, stored raw.

    python -m vit_unet_tpu_torch.cli.convert_tfrecords \\
        --input_folder data/ssid --output_folder tfrec --max_mb 1000
"""
from __future__ import annotations

import argparse
import glob
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", default="tfrec")
    p.add_argument("--prefix", default="ssid_fold")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--max_mb", type=int, default=1000)
    args = p.parse_args(argv)

    from vit_unet_tpu_torch.data.datasets import kfold_split
    from vit_unet_tpu_torch.data.image_io import imread_rgb
    from vit_unet_tpu_torch.data.tfrecord import convert, count_data_items

    clean = sorted(glob.glob(os.path.join(args.input_folder, "clean", "*")))
    noisy = sorted(glob.glob(os.path.join(args.input_folder, "noisy", "*")))
    if len(clean) != len(noisy) or not clean:
        raise ValueError("unpaired clean/noisy folders")

    def serialize(pair):
        clean_path, noisy_path = pair
        return {"x": imread_rgb(noisy_path).tobytes(),     # x = noisy
                "y": imread_rgb(clean_path).tobytes()}     # y = clean

    if args.folds < 2:   # single shard group: everything in fold 0
        fold_indices = [range(len(clean))]
    else:
        fold_indices = [val for _, val in kfold_split(len(clean), args.folds)]
    all_paths = []
    for k, val_idx in enumerate(fold_indices):
        items = [(clean[i], noisy[i]) for i in val_idx]
        paths = convert(items, args.output_folder, f"{args.prefix}_{k}_",
                        serialize, max_mb=args.max_mb)
        print(f"fold {k}: {len(items)} pairs -> {paths}")
        all_paths += paths
    total = count_data_items(all_paths)
    print(f"total items (from filenames): {total}")
    return total


if __name__ == "__main__":
    main()
