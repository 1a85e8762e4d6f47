"""Which of the exact-BN forward's outputs, taken on its f32 tensor-core
route, moves lite's f32 exact-BN train step off float64, on the card.

One batch-4 step of lite at 224² (seed 0's weights, dropout seed 7,
dropout 0.2) at head-mix BatchNorm eps 1e-3 and 1e-5, as
``chip_smoke.compare_train_paths("lite")`` takes it, with kernel 4
(``bn_fwd``) patched per variant:

* ``tc_f32``: every output from the route ``bn_fwd_route`` names;
* ``cuda_core``: every output from the CUDA-core route;
* ``sc_tc``: S, C and lse from the f32 tensor-core route, o_norm from the
  CUDA cores;
* ``onorm_tc``: o_norm from the f32 tensor-core route, S, C and lse from
  the CUDA cores;
* ``no192``: (4, 192) on the CUDA cores, (4, 12) and (4, 48) on the f32
  tensor-core route;

and the plain path in f32.  Prints loss, running statistics and gradients
against the plain path in float64 (relative to the largest float64
gradient), and the card's name and power limit.

    python3 tools/torch_lite_f32_bn_probe.py
"""
import importlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

T = importlib.import_module("vit_unet_tpu_torch.kernels.flash_reattention_train")


def mixed(f32_keys, classes=None):
    """bn_fwd taking the outputs ``f32_keys`` (indices of S, C, lse,
    o_norm) from the f32 tensor-core route and the rest from the CUDA
    cores; with ``classes``, only those (heads, dh) classes on the f32
    route at all."""
    def call(q, k, v_cat, seed, rate=0.0):
        tc = T.bn_fwd_route(q.dtype, q.shape[1], q.shape[3])
        if classes is not None and (q.shape[1], q.shape[3]) not in classes:
            tc = "cuda_core"
        a = T.launch_bn_fwd(q, k, v_cat, seed, rate, route=tc)
        b = T.launch_bn_fwd(q, k, v_cat, seed, rate, route="cuda_core")
        return tuple(x if i in f32_keys else y for i, (x, y) in enumerate(zip(a, b)))
    return call


VARIANTS = {
    "tc_f32": mixed({0, 1, 2, 3}),
    "cuda_core": mixed(set()),
    "sc_tc": mixed({0, 1, 2}),
    "onorm_tc": mixed({3}),
    "no192": mixed({0, 1, 2, 3}, classes={(4, 12), (4, 48)}),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lite_f32_bn_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 3, 224, 224, generator=gen, device="cuda")
    batch = {"x": x, "y": 0.9 * x}
    step = lambda *a, **k: chip_smoke.train_step_result(*a, preset="lite", **k)
    rel = lambda a, b: (a - b).abs().max().item() / b.abs().max().item()
    for eps in (1e-3, 1e-5):
        ref = step(False, False, batch, "float64", attn_bn_eps=eps)
        runs = {"plain": step(False, False, batch, attn_bn_eps=eps)}
        for name, fn in VARIANTS.items():
            with mock.patch.object(T, "bn_fwd", fn):
                runs[name] = step(True, False, batch, attn_bn_eps=eps)
        for name, (loss, grads, stats) in runs.items():
            print(f"eps {eps:.0e} {name:9s}: loss rel {abs(loss - ref[0]) / abs(ref[0]):.3e}, "
                  f"running stats rel {rel(stats, ref[2]):.3e}, grads rel "
                  f"{rel(grads, ref[1]):.3e} of the largest", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
