"""The port's training CLI (``python -m vit_unet_tpu_torch.cli.run_denoising``)
on the CPU: its flags against the JAX CLI's, its folds, and a one-epoch
run of lite at 64x64 per task layout."""
import json
import math
import os

import cv2
import numpy as np
import pytest

from vit_unet_tpu.cli import run_denoising as JC
from vit_unet_tpu.data.datasets import kfold_split as jax_kfold
from vit_unet_tpu_torch.cli import run_denoising as TC
from vit_unet_tpu_torch.data import loader as TL
from tests.test_torch_model import one_torch_thread  # noqa: F401

N_PAIRS = 8


def _actions(parser):
    return {a.dest: (a.default, a.type, a.choices, a.nargs, a.const,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_but_device():
    port, jax_ = _actions(TC.build_parser()), _actions(JC.build_parser())
    assert port.pop("device")[0] == "cuda"
    assert port == jax_
    assert TC.TASKS == JC.TASKS


def _folder(root, task, seed=0):
    first, second = {"denoise": ("clean", "noisy"),
                     "segment": ("images", "masks")}[task]
    rng = np.random.default_rng(seed)
    for d in (first, second):
        os.makedirs(os.path.join(root, d))
    for i in range(N_PAIRS):
        img = (np.cumsum(rng.integers(0, 12, (72, 80, 3)), axis=0) % 256).astype(np.uint8)
        cv2.imwrite(os.path.join(root, first, f"{i:03d}.png"), img)
        if task == "segment":
            other = ((rng.random((72, 80)) > 0.6) * 255).astype(np.uint8)
        else:
            other = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, second, f"{i:03d}.png"), other)
    return sorted(os.listdir(os.path.join(root, first)))


@pytest.mark.parametrize("task,key", [("denoise", "psnr"), ("segment", "dice")])
def test_main_trains_one_epoch_on_cpu(tmp_path, monkeypatch, task, key):
    data = str(tmp_path / "data")
    names = _folder(data, task)
    seen = []

    class Recording(TL.DataLoader):
        def __init__(self, dataset, *a, **kw):
            seen.append((kw.get("shuffle", False),
                         [os.path.basename(p) for p in dataset.input_paths]))
            super().__init__(dataset, *a, **kw)

    monkeypatch.setattr(TL, "DataLoader", Recording)
    ck, log = str(tmp_path / "models"), str(tmp_path / "log.jsonl")
    result = TC.main(["--task", task, "--input_folder", data, "--n_epochs", "1",
                      "--im_size", "64", "--batch_size", "2", "--flash",
                      "--num_workers", "0", "--device", "cpu",
                      "--checkpoint_dir", ck, "--log_jsonl", log])
    assert set(result) == {f"{key}_mean", f"{key}_std"}
    assert all(math.isfinite(v) for v in result.values())
    assert os.path.isfile(os.path.join(ck, "fold0", "best-checkpoint.pt"))
    with open(log) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 1 and lines[0]["epoch"] == 0
    # the folds the JAX CLI takes: fold 0 of kfold_split(n, 5)
    train_idx, val_idx = next(jax_kfold(N_PAIRS, 5))
    assert seen == [(True, [names[i] for i in train_idx]),
                    (False, [names[i] for i in val_idx])]


def test_data_parallel_raises_before_training(tmp_path, monkeypatch):
    """--data_parallel starts the process group first: a world of two
    without a rank is an error before any data is read."""
    monkeypatch.setenv("VIT_UNET_NUM_PROCESSES", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        TC.main(["--data_parallel", "--input_folder", str(tmp_path / "none"),
                 "--device", "cpu"])


def test_empty_folder_exits(tmp_path):
    os.makedirs(tmp_path / "clean")
    os.makedirs(tmp_path / "noisy")
    with pytest.raises(SystemExit, match="no sample pairs"):
        TC.main(["--input_folder", str(tmp_path), "--device", "cpu"])
