"""Peak device memory of HViTUNetTF's bf16 training steps at larger images,
and the share of kernel 3's map workspace in it, on the card.

At dh 192 the backward's tensor-core route (kernel 3's maps + products form,
``csrc/reattention_bwd_tc.cuh``) takes a bf16 workspace of
8 B H ceil16(Nq) ceil64(Nk) bytes for a call (``vit_train_bwd_workspace``),
allocated by ``launch_bwd`` for the call's length; the CUDA-core route takes
none.  For each (image side, batch) the script runs the default model
(random weights from seed 0, dropout at the config's rates, AdamW 1e-4, MSE
on y = 0.9 x) for one warm-up and one measured step:

* bf16, kernel 3 on the route ``train_bwd_route`` names (tensor cores);
* bf16, kernel 3 held on its CUDA-core route (same model, same inputs);
* float32 (every kernel on its CUDA-core route).

Each prints the peak of the measured step (``max_memory_allocated`` after
``reset_peak_memory_stats``), the largest workspace a call of it took, and
the step's ms; a run that does not fit on the card says so.  The last line
is a JSON object of the results.

    python3 tools/torch_map_workspace.py [--sizes 256:64,512:8]
"""
import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vit_unet_tpu_torch import get_hvit_unet_tf  # noqa: E402
from vit_unet_tpu_torch.kernels import _build  # noqa: E402
from vit_unet_tpu_torch.kernels import flash_reattention_train as T  # noqa: E402
from vit_unet_tpu_torch.parallel.train_step import (  # noqa: E402
    TrainState, adamw, build_step_functions)
from vit_unet_tpu_torch.train.losses import mse  # noqa: E402

GIB = 2 ** 30


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


class Workspaces:
    """``launch_bwd`` with the workspace of each call recorded."""

    def __init__(self):
        self.real, self.largest, self.calls = T.launch_bwd, 0, 0

    def __call__(self, q, k, *args, route, **kwargs):
        batch, heads, n_q, dh = q.shape
        nbytes = T._library().vit_train_bwd_workspace(
            batch, heads, n_q, k.shape[2], dh, T.ROUTES.index(route))
        self.largest = max(self.largest, nbytes)
        self.calls += 1
        return self.real(q, k, *args, route=route, **kwargs)


def one_run(side: int, batch: int, dtype: str, hold_cuda_core: bool) -> dict:
    torch.cuda.empty_cache()
    res = dict(side=side, batch=batch, dtype=dtype,
               kernel3="cuda_core" if hold_cuda_core or dtype != "bfloat16"
               else T.train_bwd_route(torch.bfloat16, 8, 192))
    spy = Workspaces()
    hold = (mock.patch.object(T, "train_bwd_route", lambda *a: "cuda_core")
            if hold_cuda_core else contextlib.nullcontext())
    model = opt = state = steps = None
    try:
        with hold, mock.patch.object(T, "launch_bwd", spy):
            model = get_hvit_unet_tf(device="cuda", seed=0, img_size=side, dtype=dtype,
                                     param_dtype=dtype).train()
            opt = adamw(model, 1e-4)
            state = TrainState.create(model=model, optimizer=opt, seed=1)
            steps = build_step_functions(model, opt, mse)
            gen = torch.Generator(device="cuda").manual_seed(2)
            x = torch.randn(batch, side, side, 3, generator=gen, device="cuda")
            data = {"x": x, "y": 0.9 * x}
            state, m = steps.train_step(state, data)        # warm-up
            m["loss"].item()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            spy.largest, spy.calls = 0, 0
            t0 = time.perf_counter()
            state, m = steps.train_step(state, data)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            res.update(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                       peak_gib=torch.cuda.max_memory_allocated() / GIB,
                       workspace_gib=spy.largest / GIB, bwd_calls=spy.calls)
            res["workspace_share"] = res["workspace_gib"] / res["peak_gib"]
    except torch.cuda.OutOfMemoryError as exc:
        res.update(fits=False, error=str(exc).splitlines()[0])
    else:
        res["fits"] = True
    finally:
        del model, opt, state, steps
        torch.cuda.empty_cache()
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="256:64,512:8",
                        help="comma-separated side:batch pairs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_map_workspace: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load("flash_reattention.cu")
    _build.load("flash_reattention_train.cu")
    name = card()
    print(f"card: {name}")
    results = []
    for pair in args.sizes.split(","):
        side, batch = (int(x) for x in pair.split(":"))
        for dtype, hold in (("bfloat16", False), ("bfloat16", True), ("float32", False)):
            r = one_run(side, batch, dtype, hold)
            results.append(r)
            if r["fits"]:
                print(f"{side}² b{batch} {dtype}, kernel 3 on {r['kernel3']}: peak "
                      f"{r['peak_gib']:.2f} GiB, largest workspace "
                      f"{r['workspace_gib']:.3f} GiB ({r['workspace_share']:.1%} of the "
                      f"peak), {r['bwd_calls']} kernel-3 calls, step {r['ms']:.1f} ms, "
                      f"loss {r['loss']:.5f} [{name}]", flush=True)
            else:
                print(f"{side}² b{batch} {dtype}, kernel 3 on {r['kernel3']}: does not "
                      f"fit ({r['error']}) [{name}]", flush=True)
    print(json.dumps({"card": name, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
