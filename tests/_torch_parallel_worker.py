"""One rank of the port's multi-process checks on the CPU (gloo); it imports
torch and the port only, never JAX.

Run as: python tests/_torch_parallel_worker.py <rank> <world> <port> <dir>

``<dir>/inputs.pkl`` holds the numpy inputs and model weights that
``tests/test_torch_parallel.py`` made; this rank writes its results to
``<dir>/rank<rank>.pkl`` (numpy arrays and numbers) for the parent to hold
against the JAX package.  A world of 2 runs the checks on a 1 x 2 mesh
(sequence and tensor parallel) and a 2 x 1 mesh (data parallel); a world
of 4 on a 2 x 2 mesh and a 4 x 1 mesh.
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
from vit_unet_tpu_torch.models import hvit_unet_tf as TTF  # noqa: E402
from vit_unet_tpu_torch.models import vit_unet as TM  # noqa: E402
from vit_unet_tpu_torch.parallel import mesh as PM  # noqa: E402
from vit_unet_tpu_torch.parallel import partition as PP  # noqa: E402
from vit_unet_tpu_torch.parallel import sequence as PS  # noqa: E402
from vit_unet_tpu_torch.parallel import train_step as TS  # noqa: E402
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


def _step_result(model, opt, steps, batch, mesh=None):
    """One step's loss, this rank's gradients, state and AdamW moments (its
    blocks of the split parameters, whose placements ``split`` names), and
    the gradient's global norm."""
    state = TrainState.create(model=model, optimizer=opt, seed=0)
    state, m = steps.train_step(state, batch)
    split = PP.placements(model)
    named = list(model.named_parameters())
    moments = {n: (N(opt.state[p]["exp_avg"]), N(opt.state[p]["exp_avg_sq"]))
               for n, p in named if p in opt.state}
    norm = TS.global_grad_norm([p for n, p in named if n not in split],
                               [p for n, p in named if n in split], mesh)
    return dict(loss=float(m["loss"]), psnr=float(m.get("psnr", np.nan)),
                grads={n: N(p.grad) for n, p in named},
                state={k: N(t) for k, t in model.state_dict().items()},
                moments=moments, norm=float(norm),
                split={n: s.dim for n, s in split.items()})


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
        out[f"{key}/{flash}"] = dict(eval=ev, **_step_result(model, opt, steps,
                                                             batch, mesh))


def zero_runs(inp, mesh, out, key="zero"):
    """ZeRO-1 against the replicated optimizer state on ``mesh`` (its data
    axis; split over its model axis too where that holds several ranks):
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
    res["split"] = sorted(PP.placements(model))
    out[key] = res


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


def tp_dropout(inp, mesh, out):
    """Tensor parallelism with dropout on: the first step's loss and the
    eval forward of a tiny ViTUNet (frozen BN, every dropout at 0.2) and
    HViTUNetTF (keras heads split, every dropout at 0.3) on ``mesh``
    against the lone process's.  The split layers draw their blocks of
    the whole tensors' masks, so only rounding may part them."""
    x = T(inp["batch"]["x"])
    tf_x = x[:, :, :32, :32].permute(0, 2, 3, 1).contiguous()
    makers = {
        "vit": (lambda: TM.ViTUNet(TM.ViTUNetConfig(
            **dict(inp["cfg"], attn_drop=0.2, proj_drop=0.2, linear_drop=0.2),
            flash_frozen_bn=True)), x),
        "tf": (lambda: TTF.HViTUNetTF(TTF.HViTUNetTFConfig(
            img_size=32, patch_size=(4, 8), transformer_layers=(1,),
            size_bottleneck=1, num_heads=2, drop_attn=0.3, drop_proj=0.3,
            drop_linear=0.3)), tf_x),
    }
    res = {}
    for name, (make, xb) in makers.items():
        got = []
        for m in (mesh, None):
            model = make().init_weights(torch.Generator().manual_seed(4))
            opt = adamw(model, 1e-3)
            steps = build_step_functions(model, opt, TL.mse, mesh=m)
            state = TrainState.create(model=model, optimizer=opt, seed=2)
            _, metrics = steps.train_step(state, {"x": xb, "y": 0.5 * xb})
            with torch.no_grad():
                ev = model(xb, deterministic=True, use_running_average=True)
            got.append((float(metrics["loss"]), N(ev), len(PP.placements(model))))
        res[name] = dict(loss=(got[0][0], got[1][0]), eval=(got[0][1], got[1][1]),
                         n_split=got[0][2])
    out["tp_dropout"] = res


def tp_checkpoint(inp, mesh, out, root, zero):
    """Checkpoints of a model split over ``mesh`` (with ZeRO-1 when
    ``zero``): a split ``Fitter`` trains an epoch and saves, and so does a
    lone one on the whole batches (the same file up to rounding); a lone
    ``Fitter`` loads the split one's checkpoint (its parameters and AdamW
    moments must be the split ones gathered, exactly), and a fresh split
    ``Fitter`` loads the lone one's (each rank its blocks, exactly)."""
    from vit_unet_tpu_torch.data.loader import DataLoader
    # frozen BN: exact BN at init magnifies the split sums' rounding over
    # the epoch's updates (the module docstring of test_torch_parallel.py)
    cfg = dict(inp["cfg"], im_size=32, patch_size=16, flash_frozen_bn=True)
    data = mesh.shape["data"]

    def fitter(m, ck, zero_sharding=False):
        model = TM.ViTUNet(TM.ViTUNetConfig(**cfg)).init_weights(
            torch.Generator().manual_seed(3))
        f = Fitter(model, learning_rate=1e-3, metrics=(), mesh=m,
                   zero_sharding=zero_sharding, checkpoint_dir=ck, device="cpu")
        f.init_state()
        return f

    def whole(f):
        """{name: [param, exp_avg, exp_avg_sq]} gathered whole (the
        parameter alone under ZeRO, whose ranks hold others' moments)."""
        split = PP.placements(f.model)
        res = {}
        for n, p in f.model.named_parameters():
            st = None if zero else f.optimizer.state.get(p)
            ts = [p.detach()] + ([st["exp_avg"], st["exp_avg_sq"]] if st else [])
            if n in split:
                ts = [PP.gather_tensor(t, f.mesh, split[n]) for t in ts]
            res[n] = ts
        return res

    def gap(a, b):
        return max(float((x - y).abs().max()) for n in a for x, y in zip(a[n], b[n]))

    split_dir = os.path.join(root, "split")
    lone_dir = os.path.join(root, f"lone{mesh.rank}")
    trained = fitter(mesh, split_dir, zero)
    trained.fit(DataLoader(_Pairs(8), 2, num_workers=0, shard_id=mesh.index("data"),
                           num_shards=data),
                n_epochs=1, save_best=False, save_last=True, verbose=False)
    reference = fitter(None, lone_dir)
    reference.fit(DataLoader(_Pairs(8), 2 * data, num_workers=0), n_epochs=1,
                  save_best=False, save_last=True, verbose=False)
    dist.barrier()                       # rank 0 has written its file
    files = [torch.load(os.path.join(d, "last-checkpoint.pt"), weights_only=True)
             for d in (split_dir, lone_dir)]
    lone = fitter(None, split_dir)
    lone.load("last-checkpoint")
    again = fitter(mesh, lone_dir, zero)
    again.load("last-checkpoint")
    split_names = PP.placements(trained.model)
    moments = [{k: [v[m] for m in ("exp_avg", "exp_avg_sq")]
                for k, v in f["optimizer"]["state"].items()} for f in files]
    out[f"tp_checkpoint/{zero}"] = dict(
        to_lone=gap(whole(trained), whole(lone)),
        to_split=gap(whole(again), whole(reference)),
        shapes=[{k: tuple(v.shape) for k, v in f["model"].items()} for f in files],
        model=[{k: N(v) for k, v in f["model"].items()} for f in files],
        moments=[{k: [N(t) for t in v] for k, v in m.items()} for m in moments],
        n_split=len(split_names))


def cli_runs(inp, out, root):
    """Both CLIs with --data_parallel on this world (each rank reads its part
    of every batch), and the long-context script on a 1 x 2 mesh."""
    from vit_unet_tpu_torch.cli import (run_classification, run_denoising,
                                        train_sp_longcontext)
    long_context = ["--device", "cpu", "--im_size", "64", "--patch_size", "16",
                    "--hidden_dim", "32", "--batch", "2", "--sp_min_tokens", "64"]
    out["cli_sp"] = train_sp_longcontext.main(long_context + ["--steps", "3"])
    out["cli_sp_exact"] = train_sp_longcontext.main(
        long_context + ["--steps", "2", "--exact_bn"])
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
        tp_checkpoint(inp, sp_mesh, out, os.path.join(root, "tp_ck"), zero=world == 4)
        if world == 4:
            zero_runs(inp, sp_mesh, out, "zero_tp")
        if world == 2:
            tp_dropout(inp, sp_mesh, out)
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
