"""StableSR-SSL: build the model from a configuration dict, and the training CLI.

    python -m ssl_tpu_torch.diffusion.main --train --base options/diffusion/ssl_base.yml \\
        --logdir logs/diffusion_ssl [--resume auto|<train_state_N.pkl>] [--device cpu] \\
        [train.max_steps=24 model.use_flash_attention=true ...]

Counterpart of ``ssl_tpu/diffusion/main.py`` (``build_from_config``,
``train``, ``apply_dotlist``, ``main``).  ``model.use_flash_attention`` and
``model.compute_dtype`` fan out to the UNet, the struct-cond encoder and the
VAE, as there, each overridable per component (``model.unet.compute_dtype``
and so on): without the first, K2 is off the path and only K1 runs; with
``compute_dtype: bfloat16`` (or the override ``model.compute_dtype=bfloat16``)
the three nets run their activations in bf16 on float32 weights, K2 runs its
bf16 kernels, and the SSL loss (K1) still sees a float32 decoded image.  The
training options come over as there: ``sslopt`` into the SSL setting
(``mask_stride`` 3 and ``capacity`` 2048 by default; a ``simself_strategy``
other than the shipped one, with the zoo's keys, routes the SSL term
through ``losses/simself_strategies.py``), ``train.lr`` and
``train.accumulate_grad_batches``.

The CLI: ``TwoStageDegradationImgMaskDataset`` batches from
``num_workers`` loader processes, the host two-stage degrader at scale 1
(LQ at the GT size, ``queue_size`` from ``degradation:``),
``no_degradation_prob`` and the NaN fallback (the clean GT as LQ), then the
model's ``train_step`` once per mini-step (``max_steps`` counts mini-steps,
``accumulate_grad_batches`` of them make an update).  Every ``log_every``
mini-steps a line with the losses, the seconds per iteration and the data
wait's and the degrader's ms; every ``image_every`` the preview grids under
``images/train/``; every ``save_every`` ``ckpt_{step}.pkl`` (the JAX CLI's
pickle: {'unet', 'structcond', 'null_context'}, numpy leaves in flax's
layout, which both packages' ``test_cli --ckpt`` read) and
``train_state_{step}.pkl`` (the port's own ``torch.save`` payload: weights,
EMA, AdamW's moments and any accumulated gradients, ``step``,
``mini_step``, the step's generator, the degrader's streams and pool, and
the process's generators); ``--resume auto`` takes the newest.  The losses
come to the host every mini-step, so the timers cover the card's work.
A top-level ``seed`` (0 by default; the JAX CLI leaves its degrader
unseeded) seeds the weights, the loader, the degrader and the step's draws.
A ``.json`` base file needs no ``yaml``.  Runs on ``cuda`` unless
``--device`` names another device.

``parallel: {data: D, tp: T, zero: false, zero_min_size: 16384}`` runs one
process per card under ``torchrun`` (gloo with ``--device cpu``)::

    torchrun --nproc_per_node 4 -m ssl_tpu_torch.diffusion.main --train --base <file> \\
        parallel.data=2 parallel.tp=2

``data`` x ``tp`` must be the world size.  Every rank loads and degrades the
global batch (``data.batch_size``, as the JAX CLI's one host does, so the
degrader's draws and pool are the JAX pipeline's) and steps on its ``data``
share; the UNet splits over ``tp`` (``parallel/tensor.py``); the logged
losses are means over the ranks, and rank 0 writes the logs' files,
previews and checkpoints, which are those of a one-rank run.  A save in the
middle of an accumulation raises at ``data`` > 1 (each rank holds its own
partial gradients).

Not ported yet, and raising ``NotImplementedError``: a ``compute_dtype``
other than float32 and bfloat16, ``train.ckpt_backend: orbax``,
reference-schema configs (``model.target``), and the checkpoint and CLIP
weight paths."""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import random
import time

import numpy as np
import torch
from torch.utils.data import Sampler

from ssl_tpu_torch.data import build_dataloader, build_dataset
from ssl_tpu_torch.data.realesr_degradation import RealESRGANDegrader
from ssl_tpu_torch.diffusion.ddpm_ssl import (DiffusionSSLConfig, StableSRSSL, full_moments,
                                              trainable)
from ssl_tpu_torch.diffusion.unet import NOT_PORTED, EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.losses.ssl_loss import SSLSetting, zoo_opts, zoo_strategy
from ssl_tpu_torch.models.base_model import _rng_state, _set_rng_state, resolve_device
from ssl_tpu_torch.ops.ssg import SSGConfig
from ssl_tpu_torch.utils.img_util import imwrite
from ssl_tpu_torch.utils.options import ordered_yaml_load, parse_value
from ssl_tpu_torch.parallel.mesh import (barrier, dp_tp_mesh, init_distributed, is_main,
                                         mean_over_ranks, shard_batch)
from ssl_tpu_torch.parallel.tensor import NETS, full_net_state, gather_tp, trained_keys
from ssl_tpu_torch.utils.weight_port import params_to_jax


def build_from_config(cfg: dict, mesh=None) -> StableSRSSL:
    """The model of ``cfg``, with the (data, model) mesh that ``parallel:``
    asks for (``parallel/mesh.py::dp_tp_mesh``) unless ``mesh`` is given."""
    model_cfg = cfg.get("model", {})
    if "target" in model_cfg:
        raise NotImplementedError(f"reference-schema configs (model.target) {NOT_PORTED}")
    par = cfg.get("parallel") or {}
    if mesh is None and par:
        mesh = dp_tp_mesh(par)
    sslopt = cfg.get("sslopt", {})
    dcfg = DiffusionSSLConfig(
        timesteps=model_cfg.get("timesteps", 1000),
        beta_schedule=model_cfg.get("beta_schedule", "linear"),
        linear_start=model_cfg.get("linear_start", 0.00085),
        linear_end=model_cfg.get("linear_end", 0.012),
        parameterization=model_cfg.get("parameterization", "eps"),
        scale_factor=model_cfg.get("scale_factor", 0.18215),
        pixel_weight=model_cfg.get("pixel_weight", 0.1),
        ssl_l1_weight=sslopt.get("l1_weight", 0.5),
        ssl_kl_weight=sslopt.get("kl_weight", 0.5),
        context_dim=model_cfg.get("context_dim", 1024),
        context_len=model_cfg.get("context_len", 77),
    )
    unet_cfg = {k: v for k, v in model_cfg.get("unet", {}).items() if k != "context_dim"}
    vae_cfg = dict(model_cfg.get("first_stage", {}))
    struct_cfg = dict(model_cfg.get("structcond") or {
        "model_channels": unet_cfg.get("model_channels", 256),
        "channel_mult": tuple(unet_cfg.get("channel_mult", (1, 1, 2, 2)))})
    for key in ("use_flash_attention", "compute_dtype"):
        if model_cfg.get(key):
            for c in (unet_cfg, vae_cfg, struct_cfg):
                c.setdefault(key, model_cfg[key])
    with torch.device("meta"):      # definitions only: init_state makes the weights
        unet = UNetModelDualcondV2(context_dim=dcfg.context_dim, **unet_cfg)
        structcond = EncoderUNetModelWT(**struct_cfg)
        vae = AutoencoderKL(**vae_cfg)
    ssg = SSGConfig(search=sslopt.get("kernel_size_search", 25),
                    window=sslopt.get("kernel_size_window", 9),
                    sigma=sslopt.get("sigma", 0.004),
                    generalization=sslopt.get("generalization", True))
    setting = SSLSetting(ssg=ssg, mask_stride=sslopt.get("mask_stride", 3),
                         capacity=sslopt.get("capacity", 2048),
                         l1_weight=dcfg.ssl_l1_weight, kl_weight=dcfg.ssl_kl_weight,
                         impl=sslopt.get("impl", "dense"),
                         strategy=zoo_strategy(sslopt), strategy_opts=zoo_opts(sslopt))
    train = cfg.get("train", {})
    return StableSRSSL(
        dcfg, unet=unet, structcond=structcond, vae=vae, ssl_setting=setting,
        lr=train.get("lr", 5e-5), accumulate=train.get("accumulate_grad_batches", 1),
        vae_ckpt=model_cfg.get("vae_ckpt"),
        clip_text_ckpt=model_cfg.get("clip_text_ckpt"),
        text_prompt=model_cfg.get("text_prompt"),
        unet_ckpt=model_cfg.get("ckpt_path") or model_cfg.get("unet_ckpt"),
        mesh=mesh, zero=bool(par.get("zero", False)),
        zero_min_size=int(par.get("zero_min_size", 2 ** 14)))


def apply_dotlist(cfg: dict, dotlist: list[str]) -> dict:
    """OmegaConf-from_dotlist-style overrides (reference main.py:482,535):
    ``a.b.c=value`` merged over the config, the value read as YAML (as JSON
    without ``yaml``), a string that reads as a float taken as one (YAML 1.1
    leaves '2e-4' a string)."""
    for item in dotlist:
        if "=" not in item:
            raise SystemExit(f"override '{item}' is not of the form key=value")
        key, _, raw = item.partition("=")
        val = parse_value(raw)
        if isinstance(val, str):
            try:
                val = float(val)
            except ValueError:
                pass
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return cfg


class EpochShuffle(Sampler):
    """The JAX loader's shuffle (``np.random.RandomState(seed + epoch)``'s
    permutation of the items), with ``set_epoch`` called at every pass."""

    def __init__(self, n: int, seed: int = 0):
        self.n, self.seed, self.epoch = n, seed, 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        return iter(np.random.RandomState(self.seed + self.epoch).permutation(self.n).tolist())

    def __len__(self):
        return self.n


def _nets(params: dict, model: StableSRSSL | None = None) -> dict:
    """The nets' state dicts, whole (gathered over ``model``'s mesh)."""
    if model is None or model.plan is None:
        return {"unet": params["unet"].state_dict(),
                "structcond": params["structcond"].state_dict(),
                "null_context": params["null_context"].detach()}
    mesh = model.mesh
    return {**{net: full_net_state(params[net], model.plan, net, mesh.tp, mesh.inner_group)
               for net in NETS}, "null_context": params["null_context"].detach()}


def _load_nets(params: dict, saved: dict) -> None:
    params["unet"].load_state_dict(saved["unet"])
    params["structcond"].load_state_dict(saved["structcond"])
    with torch.no_grad():
        params["null_context"].copy_(saved["null_context"])


def save_train_state(path: str, state, degrader: RealESRGANDegrader,
                     model: StableSRSSL | None = None) -> None:
    """``train_state_{step}.pkl``: everything a resumed run continues from.
    Under ``model``'s distributed mesh every rank enters (the state is
    gathered) and rank 0 writes the file of a one-rank run."""
    grads = None
    plan = None if model is None else model.plan
    if state.mini_step:                    # gradients summed since the last update
        if model is not None and model.distributed and model.mesh.data > 1:
            raise ValueError("a save in the middle of an accumulation at data > 1: make "
                             "save_every a multiple of accumulate_grad_batches")
        keys = trained_keys(state.params)
        grads = [None if p.grad is None else
                 (p.grad.detach() if plan is None else
                  gather_tp(p.grad.detach(), plan["params"][k], model.mesh.tp,
                            model.mesh.inner_group))
                 for k, p in zip(keys, trainable(state.params))]
    payload = {"step": state.step, "mini_step": state.mini_step,
               "params": _nets(state.params, model),
               "ema_params": None if state.ema_params is None else _nets(state.ema_params, model),
               "opt": (state.opt.state_dict() if plan is None else
                       full_moments(state.opt, plan, trained_keys(state.params))),
               "grads": grads, "generator": state.generator.get_state(),
               "degrader": degrader.get_state(), "rng": _rng_state()}
    if is_main():
        torch.save(payload, path)
    barrier()


def load_train_state(path: str, state, degrader: RealESRGANDegrader) -> None:
    """Restore ``save_train_state``'s file into ``state`` and ``degrader`` in
    place (before ``StableSRSSL.place_state``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    _load_nets(state.params, payload["params"])
    if (state.ema_params is None) != (payload["ema_params"] is None):
        raise ValueError(f"{path}: the EMA is present in one of the file and the model only")
    if state.ema_params is not None:
        _load_nets(state.ema_params, payload["ema_params"])
    state.opt.load_state_dict(payload["opt"])
    for p, g in zip(trainable(state.params), payload["grads"] or []):
        p.grad = None if g is None else g.to(p.device)
    if not payload["grads"]:
        state.opt.zero_grad(set_to_none=False)
    state.generator.set_state(payload["generator"])
    state.step, state.mini_step = int(payload["step"]), int(payload["mini_step"])
    degrader.set_state(payload["degrader"])
    _set_rng_state(payload["rng"])


def find_train_state(logdir: str) -> str | None:
    """The newest ``train_state_{step}.pkl`` in ``logdir``, if any."""
    cands = glob.glob(os.path.join(logdir, "train_state_*.pkl"))
    return max(cands, key=lambda p: int(p.rsplit("_", 1)[1][:-4])) if cands else None


def _hwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _chw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


def train(args, on_iteration=None):
    """Run the CLI for ``args`` (``base``, ``logdir``, ``resume``,
    ``overrides``, ``device``); returns the final ``DiffusionState``.
    ``on_iteration(record, state, degrader)``, if given, is called after
    each mini-step with its record (``step``, the host ``logs``, seconds
    ``iter_s``, ``data_s``, ``degrade_s`` and the degrader's
    ``degrade_parts``), the state and the degrader; its time is not an
    iteration's."""
    cfg = apply_dotlist(ordered_yaml_load(args.base), getattr(args, "overrides", None) or [])
    train_cfg = cfg.get("train", {})
    if train_cfg.get("ckpt_backend", "pickle") != "pickle":
        raise NotImplementedError(f"train.ckpt_backend={train_cfg['ckpt_backend']!r} {NOT_PORTED}")
    device = resolve_device(getattr(args, "device", None))
    if cfg.get("parallel") and "WORLD_SIZE" in os.environ:
        device = init_distributed(device)      # one rank a card under torchrun
    model = build_from_config(cfg)
    mesh = model.mesh
    rank0 = is_main()
    seed = int(cfg.get("seed", 0))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    data_cfg = cfg.get("data", {})
    gt_size = data_cfg.get("crop_size", 512)
    batch_size = data_cfg.get("batch_size", 2)
    dataset = build_dataset({**data_cfg.get("train", {}), "phase": "train",
                             "crop_size": gt_size})
    sampler = EpochShuffle(len(dataset), seed)
    loader = build_dataloader(dataset, {"phase": "train", "batch_size_per_gpu": batch_size,
                                        "num_worker_per_gpu": data_cfg.get("num_workers", 4)},
                              sampler=sampler, seed=seed, device=device)
    if len(loader) == 0:
        raise ValueError(f"{len(dataset)} training images make no batch of {batch_size}")
    deg_cfg = cfg.get("degradation", {})
    # LQ stays at the GT size (scale 1): StableSR trains on upsampled LQ
    degrader = RealESRGANDegrader(deg_cfg, scale=1, queue_size=deg_cfg.get("queue_size", 0),
                                  seed=seed)

    state = model.init_state(seed=seed, device=device)
    resume = getattr(args, "resume", None)
    if resume:
        path = find_train_state(args.logdir) if resume == "auto" else resume
        if path is not None:                 # auto with no state yet: a fresh start
            load_train_state(path, state, degrader)
            if rank0:
                print(f"resumed from {path} at step {state.step}", flush=True)
    state = model.place_state(state)        # the mesh's layout, after init and resume
    total_steps = train_cfg.get("max_steps", 800000)
    log_every = train_cfg.get("log_every", 100)
    save_every = train_cfg.get("save_every", 1000)
    image_every = train_cfg.get("image_every", save_every)
    ndp = deg_cfg.get("no_degradation_prob", 0.0)
    out_dir = args.logdir
    os.makedirs(out_dir, exist_ok=True)
    tb = None
    if train_cfg.get("use_tb_logger") and rank0:
        from ssl_tpu_torch.utils.logger import init_tb_logger
        tb = init_tb_logger(os.path.join(out_dir, "tb_logger"))

    def dump_images(step, batch):
        """A row of the batch's images per preview key, as PNG (every rank
        runs the preview; rank 0 writes)."""
        for key, val in model.preview(state, batch).items():
            if not rank0:
                continue
            grid = torch.cat(list(val.clamp(0, 1)), dim=2).permute(1, 2, 0).cpu().numpy()
            bgr = (grid[..., ::-1] * 255.0).round().astype(np.uint8)
            imwrite(np.ascontiguousarray(bgr),
                    os.path.join(out_dir, "images", "train", f"{key}_gs-{step:06d}.png"))

    step = state.step
    epoch = step // len(loader)
    window = {"iter_s": 0.0, "data_s": 0.0, "degrade_s": 0.0}
    while step < total_steps:
        sampler.set_epoch(epoch)
        batches = iter(loader)
        t_end = time.perf_counter()
        while step < total_steps:
            batch = next(batches, None)
            if batch is None:
                break
            t_data = time.perf_counter()
            parts = dict(degrader.times)
            proc = degrader({k: _hwc(batch[k]) for k in ("gt", "gt_mask") if k in batch}
                            | {k: batch[k].numpy() for k in ("kernel1", "kernel2", "sinc_kernel")}
                            | {"gt_size": gt_size})
            # no_degradation_prob (reference ddpmssl.py:237-238): now and then
            # the clean GT as LQ, as also when the degradation gives NaN
            if (ndp and np.random.rand() < ndp) or np.isnan(proc["lq"]).any():
                proc = {**proc, "lq": proc["gt"]}
            t_degrade = time.perf_counter()
            device_batch = shard_batch({k: _chw(v, device) for k, v in proc.items()}, mesh)
            state, logs = model.train_step(state, device_batch)
            host = {k: float(v) for k, v in mean_over_ranks(logs).items()}
            step = state.step
            t_prev, t_end = t_end, time.perf_counter()
            record = {"step": step, "logs": host, "iter_s": t_end - t_prev,
                      "data_s": t_data - t_prev, "degrade_s": t_degrade - t_data,
                      "degrade_parts": {k: v - parts.get(k, 0.0)
                                        for k, v in degrader.times.items()}}
            for k in window:
                window[k] += record[k]
            if on_iteration is not None:
                on_iteration(record, state, degrader)
            if step % log_every == 0 and rank0:
                n = log_every
                print(f"step {step} ({window['iter_s'] / n:.2f}s/it, data "
                      f"{1e3 * window['data_s'] / n:.1f} ms/it, degrade "
                      f"{1e3 * window['degrade_s'] / n:.1f} ms/it): {host}", flush=True)
                window = dict.fromkeys(window, 0.0)
                if tb is not None:
                    for k, v in host.items():
                        tb.add_scalar(f"losses/{k}", v, step)
            if image_every and step % image_every == 0:
                dump_images(step, device_batch)
            if save_every and step % save_every == 0:
                ckpt = params_to_jax("StableSRSSL", _nets(state.params, model))
                if rank0:
                    with open(os.path.join(out_dir, f"ckpt_{step}.pkl"), "wb") as f:
                        pickle.dump(ckpt, f)
                save_train_state(os.path.join(out_dir, f"train_state_{step}.pkl"), state,
                                 degrader, model)
            t_end = time.perf_counter()     # the saves and previews are not an iteration's
        epoch += 1
    if tb is not None:
        tb.close()
    return state


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--base", type=str, required=True)
    parser.add_argument("--logdir", type=str, default="logs/diffusion_ssl")
    parser.add_argument("--resume", type=str, default=None,
                        help="'auto' (newest train_state_*.pkl in --logdir) or a train-state path")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args, unknown = parser.parse_known_args(argv)
    args.overrides = unknown
    if not args.train:
        return None
    state = train(args)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
