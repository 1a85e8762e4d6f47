"""One rank of the port's multi-process checks on the CPU (gloo); it imports
torch and the port only, never JAX.

Run as: python tests/_torch_parallel_worker.py <rank> <world> <port> <dir>

``<dir>/inputs.pkl`` holds the numpy inputs and model weights that
``tests/test_torch_parallel.py`` made; this rank writes its results to
``<dir>/rank<rank>.pkl`` (numpy arrays and numbers) for the parent to hold
against the JAX package.  A world of 2 runs the checks on a 1 x 2 mesh
(sequence parallel) and a 2 x 1 mesh (data parallel); a world of 4 on a
2 x 2 mesh and a 4 x 1 mesh.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vit_unet_tpu_torch.kernels.flash_reattention import fold_reattention_compact  # noqa: E402
from vit_unet_tpu_torch.kernels.flash_reattention_train import (  # noqa: E402
    dropout_mask, reattention_nxn,
)
from vit_unet_tpu_torch.models import vit_unet as TM  # noqa: E402
from vit_unet_tpu_torch.parallel import mesh as PM  # noqa: E402
from vit_unet_tpu_torch.parallel import sequence as PS  # noqa: E402
from vit_unet_tpu_torch.parallel.train_step import (  # noqa: E402
    TrainState, adamw, build_step_functions,
)
from vit_unet_tpu_torch.train import losses as TL  # noqa: E402
from vit_unet_tpu_torch.train import metrics as TMet  # noqa: E402
from vit_unet_tpu_torch.train.fitter import Fitter  # noqa: E402

T = torch.from_numpy
N = lambda t: t.detach().cpu().numpy()


def _block(a, mesh, axis="data"):
    """This rank's block of the leading axis of a whole-batch array."""
    n = mesh.shape[axis]
    return a[mesh.index(axis) * (len(a) // n):(mesh.index(axis) + 1) * (len(a) // n)]


def sp_functions(inp, mesh, out):
    """The sequence-parallel functions on this rank's batch part: eval, and
    training in three modes x two bodies (forward, moments, gradients)."""
    f = inp["sp"]
    data = mesh.shape["data"] > 1
    q, k, v = (T(_block(f[n], mesh)) for n in ("q", "k", "v"))
    out["sp_eval"] = {flash: N(PS.sequence_parallel_reattention(
        q, k, v, T(f["m_eff"]), T(f["c_eff"]), mesh, use_flash=flash))
        for flash in (True, False)}
    for mode in ("frozen", "exact", "track"):
        for flash in (True, False):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)] + [
                T(f[n]).clone().requires_grad_()
                for n in ("conv_m", "conv_c", "gamma", "beta")]
            running = None if mode == "exact" else (T(f["rm"]), T(f["rv"]))
            o, mu, var = PS.sequence_parallel_reattention_train(
                *leaves, mesh, running_stats=running, use_flash=flash,
                track_stats=mode == "track", data_axis="data" if data else None)
            # each data part's loss, its share of the moments' term
            loss = (o * torch.cos(o)).sum() + (mu.sum() + var.sum()) / mesh.shape["data"]
            loss.backward()
            grads = [x.grad.clone() for x in leaves]
            for g in grads[3:]:            # the parameters: summed over data
                mesh.all_reduce(g, "data")
            out[f"sp_train/{mode}/{flash}"] = dict(
                out=N(o), mu=N(mu), var=N(var), grads=[N(g) for g in grads])


def sp_dropout(inp, mesh, out):
    """Dropout under sequence parallelism: each shard's mask is
    ``dropout_mask`` at seed + idx * 2^20 (idx = model index + s * data
    index), held against the plain N x N path with those masks stacked."""
    f = inp["sp"]
    rate, seed = 0.3, torch.tensor([1234], dtype=torch.int64)
    q, k, v = (T(_block(f[n], mesh)) for n in ("q", "k", "v"))
    b, h, n, dh = q.shape
    s = mesh.shape["model"]
    base = s * mesh.index("data")
    mask = torch.cat([dropout_mask(seed + (base + i) * PS.SEED_STRIDE, rate, b, h,
                                   n // s, n) for i in range(s)], 2)
    params = [T(f[n]) for n in ("conv_m", "conv_c", "gamma", "beta")]
    v_cat = v.transpose(1, 2).reshape(b, n, h * dh)
    res = {}
    for mode in ("frozen", "exact"):
        running = (T(f["rm"]), T(f["rv"])) if mode == "frozen" else None
        got = {flash: PS.sequence_parallel_reattention_train(
            q, k, v, *params, mesh, seed=seed, rate=rate, running_stats=running,
            use_flash=flash)[0] for flash in (True, False)}
        if mode == "frozen":
            m_eff, c_eff = fold_reattention_compact(*params, *running)
            want, _ = reattention_nxn(q, k, v_cat, m_eff, c_eff, mask)
            res["frozen_vs_nxn"] = float((got[True] - want).abs().max() / want.abs().max())
        res[f"{mode}_bodies"] = float((got[True] - got[False]).abs().max()
                                      / got[False].abs().max())
    res["mask_kept"] = float((mask > 0).float().mean())
    out["sp_dropout"] = res


def gather_forms(mesh, out):
    """The K/V gather's backward, as a reduce_scatter and as an all_reduce
    and slice: the same numbers."""
    gen = torch.Generator().manual_seed(mesh.rank)
    x = torch.randn(2, 3, 8, 5, generator=gen)
    w = torch.randn(2, 3, 8 * mesh.shape["model"], 5, generator=gen)
    grads = []
    for form in (True, False):
        xx = x.clone().requires_grad_()
        (PS.gather_tokens(xx, mesh, reduce_scatter=form) * w).sum().backward()
        grads.append(xx.grad)
    out["gather_forms"] = float((grads[0] - grads[1]).abs().max())
    out["gather_grad"] = N(grads[0])


def _model(inp, mesh, flash, sp):
    cfg = TM.ViTUNetConfig(**inp["cfg"], flash_train=flash, sequence_parallel=sp,
                           sp_min_tokens=inp["sp_min_tokens"])
    model = TM.ViTUNet(cfg, mesh=mesh if sp else None)
    model.load_state_dict({k: T(v) for k, v in inp["weights"].items()})
    return model


def _step_result(model, opt, steps, batch):
    state = TrainState.create(model=model, optimizer=opt, seed=0)
    state, m = steps.train_step(state, batch)
    return dict(loss=float(m["loss"]), psnr=float(m.get("psnr", np.nan)),
                grads={n: N(p.grad) for n, p in model.named_parameters()},
                state={k: N(t) for k, t in model.state_dict().items()})


def model_runs(inp, mesh, out, key, sp):
    """ViTUNet through its entry points on ``mesh``: the eval forward of the
    whole batch and one AdamW train step of it (split over data), both
    bodies; with ``sp`` the long levels split their tokens over model."""
    batch = {k: T(a) for k, a in inp["batch"].items()}
    for flash in (True, False):
        model = _model(inp, mesh, flash, sp)
        with torch.no_grad():
            ev = N(model(batch["x"])) if sp else None
        opt = adamw(model, 1e-4)
        steps = build_step_functions(model, opt, TL.mse, mesh=mesh,
                                     metrics={"psnr": TMet.psnr})
        out[f"{key}/{flash}"] = dict(eval=ev, **_step_result(model, opt, steps, batch))


def zero_runs(inp, mesh, out):
    """ZeRO-1 against the replicated optimizer on the data-parallel mesh:
    two steps each; this rank's share of the optimizer state."""
    batch = {k: T(a) for k, a in inp["batch"].items()}
    res = {}
    for zero in (False, True):
        model = _model(inp, mesh, True, False)
        opt = adamw(model, 1e-3)
        steps = build_step_functions(model, opt, TL.mse, mesh=mesh, zero_sharding=zero)
        state = TrainState.create(model=model, optimizer=steps.optimizer, seed=0)
        for _ in range(2):
            state, _ = steps.train_step(state, batch)
        res[zero] = {n: N(p) for n, p in model.named_parameters()}
        local = getattr(steps.optimizer, "optim", steps.optimizer)
        res[f"state_bytes/{zero}"] = sum(
            t.numel() * t.element_size() for st in local.state.values()
            for t in st.values() if torch.is_tensor(t) and t.ndim > 0)
    res["param_bytes"] = [p.numel() * p.element_size() for p in model.parameters()]
    out["zero"] = res


def remainder_and_weights(inp, mesh, out):
    """A whole batch the data axis does not divide runs replicated; a
    weighted loss splits into its whole-batch weighted mean.  Each against
    the lone-process step of the same batch."""
    x = T(inp["batch"]["x"])
    cases = {"remainder": {"x": x[:3], "y": 0.9 * x[:3]},
             "weighted": {"x": x, "y": 0.9 * x,
                          "w": torch.tensor([0.5, 2.0, 1.0, 3.0])}}
    res = {}
    for name, batch in cases.items():
        got = []
        for m in (mesh, None):
            model = _model(inp, None, True, False)
            opt = adamw(model, 1e-3)
            steps = build_step_functions(model, opt, TL.mse, mesh=m)
            got.append(_step_result(model, opt, steps, batch))
        res[name] = dict(loss=(got[0]["loss"], got[1]["loss"]),
                         grads=(got[0]["grads"], got[1]["grads"]),
                         stats=max(float(np.abs(got[0]["state"][k] - got[1]["state"][k]).max())
                                   for k in got[0]["state"] if "running" in k))
    out["remainder_weights"] = res


class _Pairs:
    def __init__(self, n=16):
        rng = np.random.default_rng(5)
        self.x = rng.standard_normal((n, 3, 32, 32)).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": 0.5 * self.x[i]}


def fitter_runs(inp, mesh, out, root):
    """Fitter on the data-parallel mesh with ZeRO-1: 2 epochs straight,
    against 1 epoch, a checkpoint, a fresh Fitter resuming, 1 more."""
    from vit_unet_tpu_torch.data.loader import DataLoader
    # no shuffling: the loader's epoch count would differ between the runs
    loader = DataLoader(_Pairs(), 2, num_workers=0,
                        shard_id=mesh.index("data"), num_shards=mesh.shape["data"])
    cfg = dict(inp["cfg"], im_size=32, patch_size=16)

    def fitter(ck):
        model = TM.ViTUNet(TM.ViTUNetConfig(**cfg)).init_weights(
            torch.Generator().manual_seed(3))
        return Fitter(model, learning_rate=1e-3, metrics=("psnr",), mesh=mesh,
                      zero_sharding=True, checkpoint_dir=ck, device="cpu")

    straight = fitter(os.path.join(root, "straight"))
    hist = straight.fit(loader, n_epochs=2, save_best=False, save_last=True,
                        verbose=False)
    first = fitter(os.path.join(root, "resumed"))
    first.fit(loader, n_epochs=1, save_best=False, save_last=True, verbose=False)
    again = fitter(os.path.join(root, "resumed"))
    again.init_state()
    start = again.resume()
    hist2 = again.fit(loader, n_epochs=2, initial_epoch=start, save_best=False,
                      save_last=True, verbose=False)
    out["fitter"] = dict(
        loss=hist["loss"], psnr=hist["psnr"], resumed_loss=hist2["loss"], start=start,
        params=max(float((a - b).abs().max()) for a, b in
                   zip(straight.model.parameters(), again.model.parameters())),
        writer=straight.writes_checkpoints,
        files=sorted(os.listdir(os.path.join(root, "straight"))))


def cli_runs(inp, out, root):
    """Both CLIs with --data_parallel on this world (each rank reads its part
    of every batch), and the long-context script on a 1 x 2 mesh."""
    from vit_unet_tpu_torch.cli import (run_classification, run_denoising,
                                        train_sp_longcontext)
    out["cli_sp"] = train_sp_longcontext.main(
        ["--device", "cpu", "--im_size", "64", "--patch_size", "16",
         "--hidden_dim", "32", "--steps", "3", "--batch", "2",
         "--sp_min_tokens", "64", "--exact_bn"])
    tiny = ["--n_epochs", "1", "--batch_size", "4", "--num_workers", "0",
            "--device", "cpu", "--data_parallel"]
    out["cli_denoise"] = run_denoising.main(
        ["--input_folder", inp["cli"]["pairs"], "--im_size", "64",
         "--checkpoint_dir", os.path.join(root, "cli_den"), *tiny])
    out["cli_classify"] = {k: float(v) for k, v in run_classification.main(
        ["--input_folder", inp["cli"]["classes"], "--im_size", "32",
         "--patch_size", "8", "--depth_te", "1", "--hidden_dim", "32",
         "--num_heads", "4", "--checkpoint_dir", os.path.join(root, "cli_cls"),
         *tiny]).items()}


def main():
    rank, world, port, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                               sys.argv[4])
    torch.set_num_threads(1)
    with open(os.path.join(root, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    out = {}
    try:
        PM.initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
        sp_mesh = PM.create_mesh(2, device="cpu")            # (world/2) x 2
        dp_mesh = PM.create_mesh(1, device="cpu")            # world x 1
        hybrid = PM.create_hybrid_mesh(2, device="cpu")      # one host
        out["meshes"] = dict(sp=sp_mesh.shape, dp=dp_mesh.shape,
                             sp_coords=sp_mesh.coords, hybrid=hybrid.grid.tolist(),
                             sp_grid=sp_mesh.grid.tolist(),
                             local=PM.data_sharding(dp_mesh).local(
                                 {"x": torch.arange(4 * world)})["x"].tolist())
        sp_functions(inp, sp_mesh, out)
        sp_dropout(inp, sp_mesh, out)
        gather_forms(sp_mesh, out)
        model_runs(inp, sp_mesh, out, "model_sp", sp=True)
        model_runs(inp, dp_mesh, out, "dp_step", sp=False)
        if world == 2:
            zero_runs(inp, dp_mesh, out)
            remainder_and_weights(inp, dp_mesh, out)
            fitter_runs(inp, dp_mesh, out, os.path.join(root, "fit"))
            cli_runs(inp, out, os.path.join(root, "cli"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        out["error"] = traceback.format_exc()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
