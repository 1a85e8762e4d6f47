"""Where the classifier's f32 exact-BN gradient error against float64 sits,
on the card: one batch-4 train step of ``ViTClassifier`` at the CLI's
widths (224², 16 heads, 8 blocks) from seed 0's weights and dropout seed 7,
on the kernel path in f32, the plain path in f32 and the plain path in
float64, at head-mix BatchNorm eps 1e-5 and 1e-3, dropout 0.2 and 0.
Prints, per path, the tensors whose gradient is furthest from float64,
relative to the largest float64 gradient (and each tensor's own largest
gradient on that scale).

    python3 tools/torch_exact_bn_grad_probe.py
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vit_unet_tpu_torch import get_vit_classifier  # noqa: E402
from vit_unet_tpu_torch.nn.reattention import ReAttention  # noqa: E402
from vit_unet_tpu_torch.parallel.train_step import (  # noqa: E402
    TrainState, build_step_functions)
from vit_unet_tpu_torch.train.losses import categorical_crossentropy  # noqa: E402

TOP = 6


def step_grads(batch, flash, dtype, eps, drop):
    model = get_vit_classifier(device="cuda", seed=0, flash_train=flash, dtype=dtype,
                               param_dtype=dtype, num_patches=196, attn_drop=drop,
                               proj_drop=drop, linear_drop=drop).train()
    for layer in model.modules():
        if isinstance(layer, ReAttention):
            layer.bn_eps = layer.var_norm.eps = eps
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    loss = lambda logits, y: categorical_crossentropy(logits, y, label_smoothing=0.05)
    steps = build_step_functions(model, opt, loss)
    steps.train_step(TrainState.create(model=model, optimizer=opt, seed=7), batch)
    return {n: p.grad.double() for n, p in model.named_parameters()}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(4, 3, 224, 224, generator=gen, device="cuda")
    labels = torch.randint(0, 4, (4,), generator=gen, device="cuda")
    batch = {"x": x, "y": torch.eye(4, device="cuda")[labels]}
    for eps, drop in ((1e-5, 0.2), (1e-5, 0.0), (1e-3, 0.2), (1e-3, 0.0)):
        kern, plain, ref = (step_grads(batch, f, dt, eps, drop) for f, dt in
                            ((True, "float32"), (False, "float32"), (False, "float64")))
        gmax = max(g.abs().max().item() for g in ref.values())
        for label, got in (("kernel", kern), ("plain", plain)):
            errs = sorted(((got[n] - ref[n]).abs().max().item() / gmax, n)
                          for n in ref)[::-1]
            print(f"eps {eps} drop {drop} {label}: worst {errs[0][0]:.3e}; top: "
                  + ", ".join(f"{n} {e:.2e} (own max "
                              f"{ref[n].abs().max().item() / gmax:.2e})"
                              for e, n in errs[:TOP]))


if __name__ == "__main__":
    main()
