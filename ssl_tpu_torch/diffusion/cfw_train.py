"""CFW (controllable feature wrapping) decoder training: StableSR's stage 2.

    python -m ssl_tpu_torch.diffusion.cfw_train --base <config> --data_root <dump> \\
        --logdir logs/cfw [--resume logs/cfw/cfw_state_N.pkl] [--device cpu] \\
        [vae.use_flash_attention=true train.max_steps=2 ...]

Counterpart of ``ssl_tpu/diffusion/cfw_train.py``.  ``AutoencoderKLResi``
(``diffusion/vae.py``) learns to decode the dumped stage-1 latents with the
LQ encoder's features fused in: the encoder and ``quant_conv`` stay frozen
(no gradient, not in the optimizer), and the decoder, ``post_quant_conv`` and
the fusion layers train.  One step, as the JAX step:

* the decode: the batch's latent / ``scale_factor`` when the dump has
  latents (the reference's ``get_input``), else the frozen encoder's mean of
  the stage-1 sample; the LQ's encoder features; both without gradient;
* G: pixel L1 x ``pixel_weight``, plus ``perceptual_opt``, plus the GAN term
  when ``network_d`` is set.  The D runs in train mode there, and its batch
  statistics are dropped (``models/srgan_model.py::frozen_discriminator``),
  as the JAX step drops them;
* Adam (``optim_g`` with the schedule), then the EMA (``ema_decay`` 0.999)
  of the trainable parameters only;
* D (with ``network_d``): on the GT, then on the detached decode, its
  batch-norm statistics chained real -> fake (the port's flax-rule
  ``BatchNorm2d``), and Adam (``optim_d``).

The reference's ``configs/autoencoder/*_resi.yaml`` (OmegaConf schema) is
read through ``diffusion/ref_config.py``, then the ``key=value`` overrides
apply; the data is ``ssl_tpu_torch.scripts.gt_input_output``'s dump root
(``{gts,inputs,samples[,latents]}``), read by ``CFWTripletDataset`` with two
``RandomState(0)`` streams, the crops' and the loop's, as the JAX CLI reads
it.  Every ``save_every`` steps and at the end: ``cfw_{step}.pkl``, the EMA
merged with the frozen encoder in the JAX layout (``{'params': tree}``, which
both packages' ``test_cli --vqgan_ckpt`` read), and ``cfw_state_{step}.pkl``,
the port's own resume file (``torch.save``: the weights, the EMA, both Adams'
moments, the D and its running statistics, the step).  A resumed run restarts
both streams, as the JAX CLI's does.  ``path.pretrain_vae`` loads an SD / ldm
VAE ``.ckpt`` / ``.pth`` (``utils/weight_port.py::load_reference_state``;
the fusion layers keep their init when the file has none) or a ``cfw_*.pkl``.
Runs on ``cuda`` unless ``--device`` names another device.

``parallel.data`` > 1 is not ported (ROADMAP.md, queue 1 item 10)."""

from __future__ import annotations

import argparse
import copy
import os
import pickle
import time
from dataclasses import dataclass

import numpy as np
import torch

from ssl_tpu_torch.diffusion.main import apply_dotlist
from ssl_tpu_torch.diffusion.ref_config import is_reference_schema, translate_reference_config
from ssl_tpu_torch.diffusion.vae import AutoencoderKLResi, init_cfw
from ssl_tpu_torch.models.base_model import build_optimizer, optimizer_step
from ssl_tpu_torch.models.lr_scheduler import build_schedule
from ssl_tpu_torch.models.srgan_model import frozen_discriminator
from ssl_tpu_torch.utils.device import resolve_device
from ssl_tpu_torch.utils.img_util import imfrombytes
from ssl_tpu_torch.utils.options import ordered_yaml_load
from ssl_tpu_torch.utils.registry import build_loss, build_network
from ssl_tpu_torch.utils.weight_port import (load_reference_state, load_torch_state_dict,
                                             params_from_jax, params_to_jax)

FROZEN = ("encoder", "quant_conv")


@dataclass
class CFWState:
    step: int
    net: AutoencoderKLResi           # the frozen encoder and the trained decoder
    ema: AutoencoderKLResi           # the EMA of the trained part; its frozen part is net's
    opt_g: torch.optim.Optimizer
    net_d: torch.nn.Module | None = None
    opt_d: torch.optim.Optimizer | None = None


def trainable(net: AutoencoderKLResi) -> list[torch.Tensor]:
    """The parameters the step trains: all but the encoder's and quant_conv's."""
    return [p for name, p in net.named_parameters() if name.split(".", 1)[0] not in FROZEN]


def read_cfw_params(path: str) -> dict:
    """The flax params tree of a ``cfw_*.pkl`` (``{'params': tree}``, numpy
    leaves in flax's layout, as either package writes it)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return payload.get("params", payload) if isinstance(payload, dict) else payload


def load_cfw_params(net: AutoencoderKLResi, path: str) -> None:
    """Load a ``cfw_*.pkl`` into ``net``, strictly."""
    net.load_state_dict(params_from_jax("AutoencoderKLResi", read_cfw_params(path)))


class CFWTrainModel:
    """Stage-2 CFW decoder trainer: the G / D alternation of the JAX model."""

    def __init__(self, opt: dict):
        self.opt = opt
        with torch.device("meta"):   # the definition; init_state makes the weights
            self.net = AutoencoderKLResi(**(opt.get("vae") or {}))
        train_opt = opt.get("train") or {}
        self.pixel_weight = float(train_opt.get("pixel_weight", 1.0))
        self.optim_g = train_opt.get("optim_g", {"type": "Adam", "lr": 1e-4})
        self.schedule_g = build_schedule(train_opt, self.optim_g.get("lr", 1e-4))
        self.perceptual_opt = train_opt.get("perceptual_opt")
        self.cri_perceptual = None
        self.has_d = bool(opt.get("network_d"))
        if self.has_d:
            self.optim_d = train_opt.get("optim_d", {"type": "Adam", "lr": 1e-4})
            self.schedule_d = build_schedule(train_opt, self.optim_d.get("lr", 1e-4))
            self.cri_gan = build_loss(train_opt.get("gan_opt", {
                "type": "GANLoss", "gan_type": "vanilla", "loss_weight": 0.1}))
        self.ema_decay = float(train_opt.get("ema_decay", 0.999))
        # the dumped latent is descaled at get_input (reference autoencoder.py:661)
        self.scale_factor = float(opt.get("scale_factor", 0.18215))

    # ------------------------------------------------------------------ state
    def init_state(self, seed: int = 0, device=None) -> CFWState:
        """Seeded weights (``vae.py::init_cfw``) on ``device`` (``cuda``
        unless named), then ``path.pretrain_vae`` over them; the EMA a copy;
        the D's weights from ``seed + 1``."""
        device = resolve_device(device)
        net = copy.deepcopy(self.net).to_empty(device=device)
        init_cfw(net, torch.Generator(device=device).manual_seed(seed))
        path = (self.opt.get("path") or {}).get("pretrain_vae")
        if path and path.endswith((".pth", ".pt", ".ckpt")):
            load_reference_state(net, load_torch_state_dict(path, "state_dict"), "vae")
        elif path:
            load_cfw_params(net, path)
        for name in FROZEN:
            getattr(net, name).requires_grad_(False)
        ema = copy.deepcopy(net).requires_grad_(False)
        state = CFWState(step=0, net=net, ema=ema,
                         opt_g=build_optimizer(self.optim_g, trainable(net), self.schedule_g))
        if self.perceptual_opt and self.cri_perceptual is None:
            self.cri_perceptual = build_loss(self.perceptual_opt).to(device)
        if self.has_d:
            net_d = build_network(copy.deepcopy(self.opt["network_d"]))
            net_d.reset_parameters(torch.Generator().manual_seed(seed + 1))
            state.net_d = net_d.to(device).train()
            state.opt_d = build_optimizer(self.optim_d, state.net_d.parameters(), self.schedule_d)
        return state

    # ------------------------------------------------------------------ apply
    def decode_cfw(self, net: AutoencoderKLResi, sr, lq, latent=None) -> torch.Tensor:
        """The reference forward (autoencoder.py:590-593): the latent (the
        batch's / scale_factor, else the encoder's mean of the stage-1 image
        ``sr``) decoded with the LQ encoder's features; z and the features
        carry no gradient."""
        with torch.no_grad():
            z = net.encode(sr)[0] if latent is None else latent / self.scale_factor
            feas = net.encode(lq)[2]
        return net.decode(z, feas)

    # ------------------------------------------------------------- train step
    def train_step(self, state: CFWState, batch: dict):
        """batch: ``gt``, ``lq`` and ``sr`` (b, 3, h, w) in [-1, 1] and
        optionally ``latent`` (b, c, h/8, w/8) in the sampler's scaled space.
        Updates ``state`` in place; returns it and the logs (0-dim tensors)."""
        net, gt = state.net, batch["gt"]
        state.opt_g.zero_grad(set_to_none=True)
        dec = self.decode_cfw(net, batch["sr"], batch["lq"], batch.get("latent"))
        l_pix = self.pixel_weight * torch.mean(torch.abs(dec - gt))
        total, logs = l_pix, {"l_pix": l_pix}
        if self.cri_perceptual is not None:
            l_percep, _ = self.cri_perceptual(dec, gt)
            if l_percep is not None:
                total = total + l_percep
                logs["l_percep"] = l_percep
        if self.has_d:
            with frozen_discriminator(state.net_d):     # batch statistics dropped
                fake_pred = state.net_d(dec)
            l_g_gan = self.cri_gan(fake_pred, True, is_disc=False)
            total = total + l_g_gan
            logs["l_g_gan"] = l_g_gan
        logs["l_total"] = total
        total.backward()
        optimizer_step(state.opt_g, self.schedule_g(state.step))
        with torch.no_grad():
            ema = trainable(state.ema)
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, trainable(net), alpha=1.0 - self.ema_decay)
        if self.has_d:
            state.opt_d.zero_grad(set_to_none=True)
            dec_sg = dec.detach()
            real_pred = state.net_d(gt)                 # running stats real, then fake
            fake_pred = state.net_d(dec_sg)
            l_d = (self.cri_gan(real_pred, True, is_disc=True)
                   + self.cri_gan(fake_pred, False, is_disc=True))
            l_d.backward()
            optimizer_step(state.opt_d, self.schedule_d(state.step))
            logs["l_d"] = l_d
        state.step += 1
        return state, {k: v.detach() for k, v in logs.items()}

    # -------------------------------------------------------------- inference
    def decode(self, state: CFWState, sr, lq, use_ema: bool = True) -> torch.Tensor:
        with torch.no_grad():
            return self.decode_cfw(state.ema if use_ema else state.net, sr, lq)


def save_cfw_params(state: CFWState, path: str, use_ema: bool = True) -> None:
    """The whole AutoencoderKLResi (the EMA, or the weights, with the frozen
    encoder) as ``{'params': tree}`` in flax's layout, for ``--vqgan_ckpt``."""
    net = state.ema if use_ema else state.net
    with open(path, "wb") as f:
        pickle.dump({"params": params_to_jax("AutoencoderKLResi", net)}, f)


def save_cfw_state(state: CFWState, path: str) -> None:
    """``cfw_state_{step}.pkl``: what a resumed run continues from."""
    torch.save({"step": state.step, "net": state.net.state_dict(),
                "ema": state.ema.state_dict(), "opt_g": state.opt_g.state_dict(),
                "net_d": None if state.net_d is None else state.net_d.state_dict(),
                "opt_d": None if state.opt_d is None else state.opt_d.state_dict()}, path)


def load_cfw_state(path: str, state: CFWState) -> None:
    """Restore ``save_cfw_state``'s file into ``state`` in place."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if (state.net_d is None) != (saved["net_d"] is None):
        raise ValueError(f"{path}: a discriminator is in one of the file and the config only")
    state.net.load_state_dict(saved["net"])
    state.ema.load_state_dict(saved["ema"])
    state.opt_g.load_state_dict(saved["opt_g"])
    if state.net_d is not None:
        state.net_d.load_state_dict(saved["net_d"])
        state.opt_d.load_state_dict(saved["opt_d"])
    state.step = int(saved["step"])


class CFWTripletDataset:
    """Aligned (gt, inputs, samples[, latents]) folders as the dump script
    writes them (the reference SingleImageNPDataset layout), read as the JAX
    ``CFWTripletDataset`` reads them: images through ``imfrombytes`` (HWC,
    BGR as decoded, [0, 1]), inputs upscaled to the GT size with
    ``utils/matlab_resize.py`` when smaller, a random crop from its own
    ``RandomState(seed)`` (8-aligned when latents are present, with the
    latent cropped at /8), then [-1, 1].  Latents are read HWC (as the JAX
    class reads them; ``SingleImageNPDataset`` also reads the reference's
    CHW).  Items are HWC numpy arrays."""

    def __init__(self, gt_dir: str, input_dir: str, output_dir: str,
                 crop_size: int = 0, seed: int = 0, latent_dir: str | None = None):
        def listing(d, exts=(".png", ".jpg", ".jpeg", ".bmp")):
            return sorted(os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(exts))

        self.gt_paths = listing(gt_dir)
        self.in_paths = listing(input_dir)
        self.out_paths = listing(output_dir)
        if not len(self.gt_paths) == len(self.in_paths) == len(self.out_paths):
            raise ValueError("gt/inputs/outputs folders must have matching file counts")
        self.np_paths = None
        if latent_dir:
            self.np_paths = listing(latent_dir, exts=(".npy",))
            if len(self.np_paths) != len(self.gt_paths):
                raise ValueError("latents folder must match gt count")
        self.crop = crop_size
        self.rng = np.random.RandomState(seed)

    @classmethod
    def from_root(cls, root: str, crop_size: int = 0, seed: int = 0):
        """The dump layout: root/{gts,inputs,samples[,latents]}."""
        latent_dir = os.path.join(root, "latents")
        return cls(os.path.join(root, "gts"), os.path.join(root, "inputs"),
                   os.path.join(root, "samples"), crop_size=crop_size, seed=seed,
                   latent_dir=latent_dir if os.path.isdir(latent_dir) else None)

    def __len__(self):
        return len(self.gt_paths)

    @staticmethod
    def _read(path):
        with open(path, "rb") as f:
            return imfrombytes(f.read(), float32=True)

    def __getitem__(self, idx):
        gt, lq, sr = (self._read(p[idx]) for p in (self.gt_paths, self.in_paths, self.out_paths))
        latent = np.load(self.np_paths[idx]) if self.np_paths else None
        if lq.shape[:2] != gt.shape[:2]:
            from ssl_tpu_torch.utils.matlab_resize import imresize
            lq = imresize(lq, gt.shape[0] / lq.shape[0])
        if self.crop:
            h, w = gt.shape[:2]
            top = self.rng.randint(0, max(1, h - self.crop + 1))
            left = self.rng.randint(0, max(1, w - self.crop + 1))
            if latent is not None:       # keep the /8 latent crop aligned
                top, left = top // 8 * 8, left // 8 * 8
                latent = latent[top // 8:(top + self.crop) // 8,
                                left // 8:(left + self.crop) // 8]
            sl = np.s_[top:top + self.crop, left:left + self.crop]
            gt, lq, sr = gt[sl], lq[sl], sr[sl]
        out = {k: v.astype(np.float32) * 2.0 - 1.0 for k, v in (("gt", gt), ("lq", lq), ("sr", sr))}
        if latent is not None:
            out["latent"] = latent.astype(np.float32)
        return out


def load_cfw_config(path: str, overrides=()) -> dict:
    """The CFW config: a reference-schema file translated (it must be a
    CFW one), then the ``key=value`` overrides."""
    cfg = ordered_yaml_load(path)
    if is_reference_schema(cfg):
        cfg = translate_reference_config(cfg)
        assert cfg.get("kind") == "cfw", \
            "not a CFW/autoencoder config: train it with ssl_tpu_torch.diffusion.main"
    return apply_dotlist(cfg, list(overrides or []))


def _chw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device)


def train(args, on_step=None) -> CFWState:
    """Run the CLI for ``args`` (``base``, ``logdir``, ``data_root``,
    ``resume``, ``overrides``, ``device``); returns the final state.
    ``on_step(step, logs, state)``, if given, is called after each step."""
    cfg = load_cfw_config(args.base, getattr(args, "overrides", None))
    if int((cfg.get("parallel") or {}).get("data", 0)) > 1:
        raise NotImplementedError("parallel.data > 1 for the CFW CLI is not ported yet "
                                  "(ROADMAP.md, queue 1 item 10)")
    device = resolve_device(getattr(args, "device", None))
    model = CFWTrainModel(cfg)
    data_cfg = cfg.get("data", {}) or {}
    tr = data_cfg.get("train", {}) or {}
    root = args.data_root or tr.get("gt_path") or tr.get("root")
    if isinstance(root, (list, tuple)):
        root = root[0]
    crop = int(data_cfg.get("crop_size", tr.get("crop_size", 0) or 0))
    ds = CFWTripletDataset.from_root(root, crop_size=crop)
    if len(ds) == 0:
        raise ValueError(f"no triplets under {root}")
    batch_size = int(data_cfg.get("batch_size", 1))

    state = model.init_state(device=device)
    if getattr(args, "resume", None):
        load_cfw_state(args.resume, state)
        print(f"resumed from {args.resume} at step {state.step}", flush=True)

    train_cfg = cfg.get("train", {}) or {}
    total_steps = int(train_cfg.get("max_steps", 100000))
    log_every = int(train_cfg.get("log_every", 100))
    save_every = int(train_cfg.get("save_every", 1500))
    os.makedirs(args.logdir, exist_ok=True)

    rng = np.random.RandomState(0)      # the loop's indices (restarted on resume, as in JAX)
    step = state.step
    t0 = time.time()
    while step < total_steps:
        idx = rng.randint(0, len(ds), size=batch_size)
        items = [ds[int(i)] for i in idx]
        batch = {k: _chw(np.stack([it[k] for it in items]), device) for k in items[0]}
        state, logs = model.train_step(state, batch)
        step = state.step
        if on_step is not None:
            on_step(step, logs, state)
        if step % log_every == 0:
            host = {k: float(v) for k, v in logs.items()}
            print(f"step {step} ({(time.time() - t0) / log_every:.2f}s/it): {host}", flush=True)
            t0 = time.time()
        if step % save_every == 0 or step >= total_steps:
            save_cfw_params(state, os.path.join(args.logdir, f"cfw_{step}.pkl"))
            save_cfw_state(state, os.path.join(args.logdir, f"cfw_state_{step}.pkl"))
    return state


def main(argv=None) -> CFWState:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", required=True,
                        help="CFW config (native, or the reference's "
                             "configs/autoencoder/*_resi.yaml)")
    parser.add_argument("--logdir", default="logs/cfw")
    parser.add_argument("--data_root", default=None,
                        help="the dump root ({gts,inputs,samples[,latents]}) over the config's")
    parser.add_argument("--resume", default=None, help="a cfw_state_*.pkl")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args, unknown = parser.parse_known_args(argv)
    args.overrides = unknown
    return train(args)


if __name__ == "__main__":
    main()
