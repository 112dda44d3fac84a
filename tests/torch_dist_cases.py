"""Gloo worlds for the port's multi-rank tests, and what their ranks run.

``run_world(fn, world, *args)`` spawns ``world`` processes on the CPU, each
with one torch thread and a process group of gloo whose collectives time
out after 60 s; each calls ``fn(rank, world, *args)`` and its result comes
back to the parent.  A rank that has not ended after 120 s fails the test
(a deadlocked collective), as does one that raises (its traceback is
reported).  This module imports no JAX: the children stay light, and the
JAX references are computed in the parent."""

from __future__ import annotations

import copy
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

PG_TIMEOUT, JOIN_TIMEOUT = 60, 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(fn, rank, world, port, tmp, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ssl_tpu_torch.parallel.mesh import init_distributed
    try:
        init_distributed("cpu", timeout=PG_TIMEOUT)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world: int, *args, after_start=None):
    """The results of ``fn(rank, world, *args)`` on each rank of a gloo world,
    in rank order.  ``after_start()``, when given, runs in the parent while
    the ranks run; its result is returned after theirs."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_child, args=(fn, r, world, port, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        extra = after_start() if after_start is not None else None
        deadline = time.time() + JOIN_TIMEOUT
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        assert not errors, "\n".join(errors)
        assert not hung, f"ranks {hung} did not end within {JOIN_TIMEOUT} s"
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
        out = [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
               for r in range(world)]
    return (out, extra) if after_start is not None else out


# ------------------------------------------------------------ the GAN step

def esrgan_opt(fsdp: int = 1, num_feat: int = 8, num_block: int = 1, min_size: int = 32):
    """tests/test_torch_train_step.py's tiny ESRGAN-SSL option dict
    (RRDBNet nf 8, VGGStyleDiscriminator nf 4 at 128^2, relativistic GAN,
    SSL search 9 / window 5), with ``parallel.fsdp``."""
    opt = {
        "name": "dist", "model_type": "ESRGANSSLModel", "scale": 4, "manual_seed": 0,
        "datasets": {"train": {"gt_size": 128}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3,
                      "num_feat": num_feat, "num_block": num_block, "num_grow_ch": 4},
        "network_d": {"type": "VGGStyleDiscriminator", "num_in_ch": 3, "num_feat": 4,
                      "input_size": 128},
        "path": {},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 9,
                        "sigma": 0.1, "kernel_size_window": 5, "generalization": True},
        "parallel": {"fsdp": fsdp, "fsdp_min_size": min_size},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3,
                             "reduction": "mean", "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0,
        },
    }
    return opt


def gan_batch(b: int = 4, gt: int = 128) -> dict:
    """A global NCHW batch whose halves hold different edge densities (0.3
    and 0.1), so that two data ranks count different SSL edges."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:gt, 0:gt] / gt
    base = np.stack([np.sin(6 * yy) + np.cos(5 * xx), yy * xx, np.cos(8 * (yy + xx))])
    hr = np.stack([base * (0.3 - 0.02 * i) + 0.5 - 0.03 * i for i in range(b)]).astype(np.float32)
    lq = hr.reshape(b, 3, gt // 4, 4, gt // 4, 4).mean(axis=(3, 5))
    lq = lq + rng.randn(*lq.shape).astype(np.float32) * 0.02
    density = np.where(np.arange(b) < b // 2, 0.3, 0.1)[:, None, None, None]
    mask = (rng.rand(b, 1, gt, gt) < density).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in (("lq", lq), ("gt", hr), ("gt_mask", mask))}


def snapshot(state) -> dict:
    """Full host copies of G, its EMA and D (gathered where sharded)."""
    from ssl_tpu_torch.parallel.fsdp import full_state_dict
    out = {"g": full_state_dict(state.net_g), "g_ema": full_state_dict(state.net_g_ema)}
    if state.net_d is not None:
        out["d"] = full_state_dict(state.net_d)
    return out


def train_steps(rank, world, opt, batch, n_steps, save_dir=None):
    """``n_steps`` of the recipe on this rank's rows of ``batch`` (the port's
    world-1 run when called in the parent with ``world`` 1); returns, per
    step, the logs (means over the ranks) and the nets, and the sharding of
    G's parameters.  With ``save_dir`` the training state and nets are saved
    after the last step."""
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.parallel.mesh import mean_over_ranks, shard_batch
    model = build_model(copy.deepcopy(opt), device="cpu")
    state = model.place_state(model.init_state(seed=0))
    local = shard_batch(batch, model.mesh)
    runs = []
    for _ in range(n_steps):
        state, logs = model.train_step(state, local)
        runs.append(({k: float(v) for k, v in mean_over_ranks(logs).items()}, snapshot(state)))
    sharded = sorted(n for n, p in state.net_g.named_parameters()
                     if type(p).__name__ == "DTensor")
    if save_dir is not None:
        model.save_networks(state, os.path.join(save_dir, "models"), n_steps)
        model.save_training_state(state, os.path.join(save_dir, "states"), 0, n_steps)
    return {"runs": runs, "sharded": sharded, "rows": int(local["lq"].shape[0])}


def sr_fsdp_step(rank, world, opt, batch, params):
    """One SRModel step on the 2-D mesh from the carried JAX weights."""
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.parallel.fsdp import full_state_dict
    from ssl_tpu_torch.parallel.mesh import mean_over_ranks, shard_batch
    model = build_model(copy.deepcopy(opt), device="cpu")
    state = model.init_state(seed=0)
    state.net_g.load_state_dict(params)
    state.net_g_ema.load_state_dict(params)
    state = model.place_state(state)
    local = shard_batch(batch, model.mesh)
    state, logs = model.train_step(state, local)
    placements = {n: str(p.placements) for n, p in state.net_g.named_parameters()
                  if type(p).__name__ == "DTensor"}
    return {"logs": {k: float(v) for k, v in mean_over_ranks(logs).items()},
            "g": full_state_dict(state.net_g), "g_ema": full_state_dict(state.net_g_ema),
            "placements": placements, "lq": local["lq"].clone(),
            "foreach": [g.get("foreach") for g in state.opt_g.param_groups]}


# --------------------------------------------------------- spatial inference

def spatial_cases(rank, world, net_opt, sd, cases):
    """``spatial_infer`` of the carried net on each (image, halo) case."""
    from ssl_tpu_torch.parallel.spatial import spatial_infer
    from ssl_tpu_torch.utils.registry import build_network
    net = build_network(dict(net_opt)).eval()
    net.load_state_dict(sd)
    with torch.no_grad():
        return [spatial_infer(net, img, 4, halo=halo) for img, halo in cases]


# ------------------------------------------------------- the diffusion step

def diffusion_steps(rank, world, parallel, confs, sds, batch, n_steps):
    """``n_steps`` mini-steps of a tiny StableSR-SSL (``confs``: the
    DiffusionSSLConfig, UNet, encoder, VAE and SSL-setting keywords) from the
    weights ``sds`` on the (data, model) mesh of ``parallel`` (one rank and
    no mesh when ``world`` is 1); returns the logs (means over the ranks),
    the gathered weights and EMA, the heads each attention call saw, and at
    one rank the gradients AdamW applied last."""
    from ssl_tpu_torch.diffusion import unet as unet_mod
    from ssl_tpu_torch.diffusion.ddpm_ssl import DiffusionSSLConfig, StableSRSSL
    from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
    from ssl_tpu_torch.diffusion.vae import AutoencoderKL
    from ssl_tpu_torch.losses.ssl_loss import SSLSetting
    from ssl_tpu_torch.ops.ssg import SSGConfig
    from ssl_tpu_torch.parallel.mesh import dp_tp_mesh, mean_over_ranks, shard_batch
    from ssl_tpu_torch.parallel.tensor import NETS, full_net_state
    mesh = dp_tp_mesh(parallel) if world > 1 else None
    model = StableSRSSL(DiffusionSSLConfig(**confs["cfg"]),
                        unet=UNetModelDualcondV2(**confs["unet"]),
                        structcond=EncoderUNetModelWT(**confs["struct"]),
                        vae=AutoencoderKL(**confs["vae"]),
                        ssl_setting=SSLSetting(ssg=SSGConfig(**confs["ssg"]), **confs["ssl"]),
                        mesh=mesh, zero=bool(parallel.get("zero")),
                        zero_min_size=int(parallel.get("zero_min_size", 2 ** 14)))
    state = model.init_state(seed=0, device="cpu")
    for tree in (state.params, state.ema_params):
        for net in NETS:
            tree[net].load_state_dict(sds[net])
        with torch.no_grad():
            tree["null_context"].copy_(sds["null_context"])
    state.frozen["vae"].load_state_dict(sds["vae"])
    state = model.place_state(state)
    grads = {}
    if model.plan is None:        # one rank: the gradients AdamW applies, by key
        from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
        from ssl_tpu_torch.parallel.tensor import trained_keys
        keys = trained_keys(state.params)
        state.opt.register_step_pre_hook(lambda *_: grads.update(
            (k, p.grad.clone()) for k, p in zip(keys, trainable(state.params))))
    heads = []
    real = unet_mod.sdp_attention
    unet_mod.sdp_attention = lambda q, *a: heads.append(int(q.shape[2])) or real(q, *a)
    local = shard_batch(batch, mesh)
    logs = []
    try:
        for _ in range(n_steps):
            state, step_logs = model.train_step(state, local)
            logs.append({k: float(v) for k, v in mean_over_ranks(step_logs).items()})
    finally:
        unet_mod.sdp_attention = real

    def whole(tree):
        if model.plan is None:
            return {net: {k: v.clone() for k, v in tree[net].state_dict().items()}
                    for net in NETS}
        return {net: full_net_state(tree[net], model.plan, net, mesh.tp, mesh.inner_group)
                for net in NETS}

    return {"logs": logs, "params": whole(state.params), "ema": whole(state.ema_params),
            "heads": heads, "rows": int(local["gt"].shape[0]), "grads": grads}


# ------------------------------------------------------ tiles in parallel

def tile_fn(t):
    """A deterministic stand-in for ddim's sample function."""
    return torch.tanh(t * 1.5 + 0.25) + t.mean()


def tiles(rank, world, z):
    from ssl_tpu_torch.diffusion.sampler import tiled_sample
    return tiled_sample(tile_fn, z, tile=8, overlap=2, data_parallel=True)


def in_one_world(rank, world, calls):
    """Each (function, args) of ``calls`` in turn on this rank of one world
    (a spawn costs seconds); returns their results in order."""
    return [fn(rank, world, *args) for fn, args in calls]


def diffusion_cli(rank, world, argv):
    """``python -m ssl_tpu_torch.diffusion.main`` with ``argv`` on this rank
    (it ends the process group: call it last)."""
    from ssl_tpu_torch.diffusion import main as dmain
    dmain.main(list(argv))
