"""StableSR-SSL latent diffusion: the configuration, the train step and serving.

Counterpart of ``ssl_tpu/diffusion/ddpm_ssl.py``.  The JAX package keeps the
state as a pytree of parameters applied to stateless flax modules; here the
state holds the modules themselves, with their parameters, and the step
updates it in place (returning it, so the call reads like the JAX one):

    JAX DiffusionTrainState      DiffusionState here
    params['unet']               params['unet']        UNetModelDualcondV2
    params['structcond']         params['structcond']  EncoderUNetModelWT
    params['null_context']       params['null_context'] (context_len, context_dim) leaf
    frozen['vae']                frozen['vae']          AutoencoderKL
    ema_params                   ema_params (a copy of params at init)
    step                         step (mini-steps taken)
    rng                          generator (a torch.Generator on the device)
    opt_state (MultiSteps)       opt (torch.optim.AdamW), mini_step, and the
                                 gradients accumulated in the parameters' .grad

The train step follows the JAX one step for step: a no-grad VAE encode of
[gt; lq], q_sample, the UNet over the struct-cond features and the null
context, the eps / v / x0 loss, the differentiable decode of x0 under remat,
the pixel L1 and the SSL loss (K1) on it, AdamW with optax's defaults every
``accumulate`` mini-steps on the mean gradient (``optax.MultiSteps``), and the
LitEma update every mini-step.  The text context is the learned null context
(no CLIP weights are in the repository).

With a distributed ``mesh`` (``parallel/mesh.py::dp_tp_mesh``, the JAX
``mesh``) the step keeps the JAX step's global-batch semantics: each rank
takes its ``data`` share of the global batch and its rows of the global
batch's draws, the SSL count is global (``losses/ssl_loss.py``), the
accumulated gradients are averaged over ``data`` before AdamW, and
``place_state`` splits the UNet and the struct-cond encoder over ``model``
(``parallel/tensor.py``; ``zero`` adds ZeRO-1 for AdamW's moments)."""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssl_tpu_torch.diffusion.schedules import (DiffusionSchedule, build_schedule_arrays, get_v,
                                               make_beta_schedule, predict_start_from_noise,
                                               predict_start_from_v, q_sample)
from ssl_tpu_torch.diffusion.unet import (EncoderUNetModelWT, UNetModelDualcondV2,
                                          init_params)
from ssl_tpu_torch.diffusion.vae import AutoencoderKL
from ssl_tpu_torch.losses.ssl_loss import SSLSetting, ssl_loss
from ssl_tpu_torch.models.base_model import resolve_device
from ssl_tpu_torch.ops.ssg import SSGConfig
from ssl_tpu_torch.parallel.tensor import NETS, ZeroAdamW, apply_tp, state_plan, trained_keys

# optax.adamw's defaults, which the JAX step takes (torch's AdamW defaults to
# a weight decay of 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


class DiffusionSSLConfig(NamedTuple):
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.012
    parameterization: str = "eps"        # 'eps' | 'x0' | 'v'
    scale_factor: float = 0.18215        # latent scaling (SD convention)
    pixel_weight: float = 0.1
    ssl_l1_weight: float = 0.5
    ssl_kl_weight: float = 0.5
    context_dim: int = 1024
    context_len: int = 77
    learn_logvar: bool = False


@dataclass
class DiffusionState:
    step: int
    params: dict                     # {'unet', 'structcond', 'null_context'}
    frozen: dict                     # {'vae'}: the first stage is frozen
    ema_params: dict | None = None
    opt: torch.optim.Optimizer | None = None
    generator: torch.Generator | None = None   # the step's draws
    mini_step: int = 0               # gradients accumulated since the last update


def _materialize(template: nn.Module, device, generator) -> nn.Module:
    """A fresh copy of ``template`` on ``device`` with seeded weights (the
    template may live on the meta device and hold no memory)."""
    return init_params(copy.deepcopy(template).to_empty(device=device), generator)


def latent_shape(vae: AutoencoderKL, b: int, h: int, w: int) -> tuple[int, int, int, int]:
    """The VAE's latent of a (b, 3, h, w) image: one halving per level but the last."""
    down = 2 ** (len(vae.decoder.up) - 1)
    return (b, vae.embed_dim, h // down, w // down)


def trainable(params: dict) -> list[torch.Tensor]:
    """The parameters the step trains, in a fixed order: the UNet's, the
    struct-cond encoder's, the null context."""
    return [*params["unet"].parameters(), *params["structcond"].parameters(),
            params["null_context"]]


class StableSRSSL:
    """Holds the configuration, the three networks' definitions and the
    training options; the weights live in the state that ``init_state`` makes."""

    def __init__(self, cfg: DiffusionSSLConfig = DiffusionSSLConfig(),
                 unet: UNetModelDualcondV2 | None = None,
                 structcond: EncoderUNetModelWT | None = None,
                 vae: AutoencoderKL | None = None, ssl_setting: SSLSetting | None = None,
                 lr: float = 5e-5, accumulate: int = 1, vae_ckpt: str | None = None,
                 clip_text_ckpt: str | None = None, unet_ckpt: str | None = None,
                 text_prompt: str | None = None, use_ema: bool = True,
                 ema_decay: float = 0.9999, mesh=None, zero: bool = False,
                 zero_min_size: int = 2 ** 14):
        for name, value in (("vae_ckpt", vae_ckpt), ("clip_text_ckpt", clip_text_ckpt),
                            ("unet_ckpt", unet_ckpt), ("text_prompt", text_prompt)):
            if value:
                raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md, queue 1): no "
                                          "such weight file is in the repository")
        self.mesh, self.zero, self.zero_min_size = mesh, zero, zero_min_size
        self.plan = None
        self.cfg = cfg
        with torch.device("meta"):
            self.unet = unet or UNetModelDualcondV2(context_dim=cfg.context_dim)
            self.structcond = structcond or EncoderUNetModelWT()
            self.vae = vae or AutoencoderKL()
        self.ssl_setting = ssl_setting or SSLSetting(
            ssg=SSGConfig(), mask_stride=3, l1_weight=cfg.ssl_l1_weight,
            kl_weight=cfg.ssl_kl_weight)
        self.lr = lr
        self.accumulate = accumulate
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.sched: DiffusionSchedule = build_schedule_arrays(
            make_beta_schedule(cfg.beta_schedule, cfg.timesteps, cfg.linear_start, cfg.linear_end))
        self._train_step = self._preview = None

    def init_state(self, seed: int = 0, device=None) -> DiffusionState:
        """Seeded weights on ``device`` (``cuda`` unless the caller names
        another): lecun-normal convs and linears, the layers the JAX package
        zero-initialises at 0, the null context ~ N(0, 0.02^2) as a leaf that
        requires grad, and the EMA a copy of the weights.  The generator that
        drew the weights goes on to draw the steps' t and noise; AdamW's
        moments are made at its first update."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        vae = _materialize(self.vae, device, gen).requires_grad_(False)
        params = {
            "unet": _materialize(self.unet, device, gen),
            "structcond": _materialize(self.structcond, device, gen),
            "null_context": (torch.randn((self.cfg.context_len, self.cfg.context_dim),
                                         generator=gen, device=device) * 0.02).requires_grad_(True),
        }
        ema = None
        if self.use_ema:
            ema = copy.deepcopy(params)
            for t in trainable(ema):
                t.requires_grad_(False)
        opt = torch.optim.AdamW(trainable(params), lr=self.lr, **ADAMW)
        return DiffusionState(step=0, params=params, frozen={"vae": vae}, ema_params=ema, opt=opt,
                              generator=gen)

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.mesh.distributed

    def place_state(self, state: DiffusionState) -> DiffusionState:
        """Lay the state out on the mesh, after init and resume (the JAX
        ``place_state``): the UNet's and the struct-cond encoder's Megatron
        layers, in the weights and the EMA, split over ``model``, and AdamW
        (with its moments) rebuilt as ``parallel/tensor.py::ZeroAdamW``.
        Nothing without a distributed mesh."""
        if not self.distributed:
            return state
        mesh = self.mesh
        plan = state_plan(state.params, mesh.tp, self.zero, self.zero_min_size)
        keys = trained_keys(state.params)
        saved = state.opt.state_dict()
        for tree in (state.params, state.ema_params):
            if tree is not None:
                for net in NETS:
                    apply_tp(tree[net], plan, net, mesh.tp, mesh.inner_rank, mesh.inner_group)
        params = trainable(state.params)
        state.opt = ZeroAdamW(params, keys, plan, mesh.tp, mesh.inner_rank, mesh.inner_group,
                              lr=self.lr, **ADAMW)
        state.opt.load_state_dict(_local_moments(saved, plan, keys, state.opt))
        self.plan = plan
        return state

    def infer_params(self, state: DiffusionState) -> dict:
        """Sampling-time weights: the EMA when tracked (the reference samples
        under LitEma's ema_scope)."""
        return state.ema_params if state.ema_params is not None else state.params

    def encode(self, vae: AutoencoderKL, img: torch.Tensor, generator=None, noise=None):
        """[-1, 1] image (b, 3, h, w) -> scaled latent sample.  The posterior
        noise is drawn from ``generator`` unless ``noise`` is given."""
        mean, logvar = vae.encode(img)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return (mean + torch.exp(0.5 * logvar) * noise) * self.cfg.scale_factor

    def decode(self, vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
        return vae.decode(z / self.cfg.scale_factor)

    def apply_model(self, params: dict, z_noisy, t, context, z_lq):
        feats = params["structcond"](z_lq, t)
        return params["unet"](z_noisy, t, context, feats)

    def _x0_and_target(self, model_out, z_noisy, z0, t, noise):
        """The parameterization's x0 prediction and regression target."""
        p = self.cfg.parameterization
        if p == "eps":
            return predict_start_from_noise(self.sched, z_noisy, t, model_out), noise
        if p == "v":
            return (predict_start_from_v(self.sched, z_noisy, t, model_out),
                    get_v(self.sched, z0, noise, t))
        return model_out, z0

    def draws(self, state: DiffusionState, gt: torch.Tensor) -> dict:
        """One mini-step's random numbers from the state's generator: the
        encoder's posterior noise for [gt; lq], t and the diffusion noise.
        Under a distributed mesh they are drawn for the global batch (every
        rank draws alike) and this rank keeps its rows."""
        gen, dev = state.generator, gt.device
        b, data = gt.shape[0], (self.mesh.data if self.distributed else 1)
        shape = latent_shape(state.frozen["vae"], b * data, gt.shape[2], gt.shape[3])
        enc = torch.randn((2 * shape[0], *shape[1:]), generator=gen, device=dev)
        t = torch.randint(0, self.sched.num_timesteps, shape[:1], generator=gen, device=dev)
        noise = torch.randn(shape, generator=gen, device=dev)
        if data > 1:
            r = self.mesh.data_rank
            rows = slice(r * b, (r + 1) * b)
            enc = torch.cat([enc[:shape[0]][rows], enc[shape[0]:][rows]])
            t, noise = t[rows], noise[rows]
        return {"enc_noise": enc, "t": t, "noise": noise}

    def make_train_step(self):
        cfg = self.cfg

        def step_fn(state: DiffusionState, batch: dict, draws: dict | None = None):
            """batch: gt and lq (b, 3, h, w) in [0, 1], lq already upsampled to
            the GT size, and optionally gt_mask (b, 1, h, w).  ``draws``
            ({'enc_noise', 't', 'noise'}) replaces the generator's.  Updates
            ``state`` in place; returns it and the logs (0-dim tensors)."""
            params, vae = state.params, state.frozen["vae"]
            gt01 = batch["gt"]
            b = gt01.shape[0]
            if draws is None:
                draws = self.draws(state, gt01)
            t, noise = draws["t"], draws["noise"]
            with torch.no_grad():     # one frozen-encoder pass over [gt; lq]
                imgs = torch.cat([gt01, batch["lq"]]) * 2.0 - 1.0
                z0, z_lq = self.encode(vae, imgs, noise=draws["enc_noise"]).chunk(2)
            z_noisy = q_sample(self.sched, z0, t, noise)
            context = params["null_context"].expand(b, *params["null_context"].shape)
            model_out = self.apply_model(params, z_noisy, t, context, z_lq)
            x0_pred, target = self._x0_and_target(model_out, z_noisy, z0, t, noise)
            l_simple = torch.mean((model_out - target) ** 2)

            setting = self.ssl_setting
            use_ssl = "gt_mask" in batch and (setting.l1_weight > 0 or setting.kl_weight > 0)
            logs = {"l_simple": l_simple}
            total = l_simple
            if cfg.pixel_weight > 0 or use_ssl:
                # the decode stays in the grad graph; remat bounds its memory
                if vae.decoder.remat_blocks:
                    img_pred = self.decode(vae, x0_pred)      # per-block checkpoints inside
                else:
                    img_pred = checkpoint(self.decode, vae, x0_pred, use_reentrant=False)
                img01 = torch.clamp((img_pred + 1.0) / 2.0, 0.0, 1.0)
                l_pixel = cfg.pixel_weight * torch.mean(torch.abs(img01 - gt01))
                logs["l_pixel"] = l_pixel
                total = total + l_pixel
                if use_ssl:
                    l_ss, l_kl = ssl_loss(img01, gt01, batch["gt_mask"], setting, self.mesh)
                    total = total + l_ss + l_kl
                    logs["l_selfsim"] = l_ss
                    logs["l_selfsim_kl"] = l_kl
            logs["l_total"] = total
            total.backward()
            self._update(state)
            return state, {k: v.detach() for k, v in logs.items()}

        return step_fn

    @torch.no_grad()
    def _update(self, state: DiffusionState) -> None:
        """optax.MultiSteps(adamw): the gradients add up in .grad; every
        ``accumulate``-th mini-step AdamW applies their mean and clears them,
        and the other mini-steps leave the weights and AdamW's step count as
        they are.  Then the LitEma update, every mini-step, with decay
        min(ema_decay, (1 + n) / (10 + n)), n the mini-steps before this one."""
        params = trainable(state.params)
        state.mini_step += 1
        if state.mini_step == self.accumulate:
            grads = []
            for p in params:      # JAX's gradient of an unused leaf is 0, and decays
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            if self.distributed:  # the mean over the data ranks
                _all_reduce_mean(grads, self.mesh.data_group, self.mesh.data)
            if self.accumulate > 1:
                torch._foreach_div_(grads, float(self.accumulate))
            state.opt.step()
            state.opt.zero_grad(set_to_none=False)
            state.mini_step = 0
        if state.ema_params is not None:
            n = float(state.step)
            decay = min(self.ema_decay, (1.0 + n) / (10.0 + n))
            ema = trainable(state.ema_params)
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, params, alpha=1.0 - decay)
        state.step += 1

    def train_step(self, state: DiffusionState, batch: dict, draws: dict | None = None):
        if self._train_step is None:
            self._train_step = self.make_train_step()
        return self._train_step(state, batch, draws)

    def make_preview(self):
        """Training-time image preview (the reference's ImageLogger): inputs,
        GT, VAE reconstruction and the one-step decoded x0 prediction at
        t = T/2 with the sampling-time weights, all in [0, 1].  Its draws come
        from a generator seeded 0 (the same posterior noise for gt and lq, as
        the JAX preview uses one key for both) unless ``draws``
        ({'enc_noise', 'noise'}) are handed in, so successive previews are
        comparable."""
        cfg, sched = self.cfg, self.sched

        @torch.no_grad()
        def preview_fn(state: DiffusionState, batch: dict, draws: dict | None = None):
            vae, params = state.frozen["vae"], self.infer_params(state)
            gt = batch["gt"] * 2.0 - 1.0
            lq = batch["lq"] * 2.0 - 1.0
            b = gt.shape[0]
            if draws is None:
                shape = latent_shape(vae, b, gt.shape[2], gt.shape[3])
                gen = torch.Generator(device=gt.device).manual_seed(0)
                draws = {"enc_noise": torch.randn(shape, generator=gen, device=gt.device),
                         "noise": torch.randn(shape, generator=gen, device=gt.device)}
            z0 = self.encode(vae, gt, noise=draws["enc_noise"])
            z_lq = self.encode(vae, lq, noise=draws["enc_noise"])
            t = torch.full((b,), sched.num_timesteps // 2, dtype=torch.long, device=gt.device)
            z_noisy = q_sample(sched, z0, t, draws["noise"])
            context = params["null_context"].expand(b, *params["null_context"].shape)
            model_out = self.apply_model(params, z_noisy, t, context, z_lq)
            x0_pred = self._x0_and_target(model_out, z_noisy, z0, t, draws["noise"])[0]

            def to01(x):
                return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)

            return {"inputs": batch["lq"], "gt": batch["gt"],
                    "reconstruction": to01(self.decode(vae, z0)),
                    "pred_x0": to01(self.decode(vae, x0_pred))}

        return preview_fn

    def preview(self, state: DiffusionState, batch: dict, draws: dict | None = None):
        if self._preview is None:
            self._preview = self.make_preview()
        return self._preview(state, batch, draws)


@torch.no_grad()
def _all_reduce_mean(tensors: list, group, n: int, bucket: int = 2 ** 24) -> None:
    """Each tensor replaced by its mean over ``group`` (``n`` ranks), in
    all-reduces of up to ``bucket`` values."""
    import torch.distributed as dist
    start = 0
    while start < len(tensors):
        end, size = start, 0
        while end < len(tensors) and (end == start or size + tensors[end].numel() <= bucket):
            size += tensors[end].numel()
            end += 1
        flat = torch.cat([t.reshape(-1) for t in tensors[start:end]])
        dist.all_reduce(flat, group=group)
        flat /= n
        for t, part in zip(tensors[start:end], flat.split([t.numel() for t in tensors[start:end]])):
            t.copy_(part.view_as(t))
        start = end


def _local_moments(saved: dict, plan: dict, keys: list, opt: ZeroAdamW) -> dict:
    """A one-rank AdamW state dict with each moment cut to this rank's slice
    (``plan["moments"]``), for ``ZeroAdamW.load_state_dict``."""
    state = {}
    for i, s in saved["state"].items():
        dim, slot = plan["moments"][keys[i]], opt.slots[i]
        state[i] = {k: (v.narrow(dim, opt.rank * slot.shape[dim], slot.shape[dim]).clone()
                        if dim is not None and torch.is_tensor(v) and v.dim() else v)
                    for k, v in s.items()}
    return {"state": state, "param_groups": saved["param_groups"]}


def full_moments(opt, plan: dict, keys: list) -> dict:
    """``opt``'s state dict with every moment gathered whole: the one-rank
    AdamW's layout (``ZeroAdamW``; a plain optimizer's own)."""
    from ssl_tpu_torch.parallel.tensor import gather_tp
    sd = opt.state_dict()
    if not isinstance(opt, ZeroAdamW):
        return sd
    sd["state"] = {i: {k: (gather_tp(v, plan["moments"][keys[i]], opt.tp, opt.group)
                           if torch.is_tensor(v) and v.dim() else v) for k, v in s.items()}
                   for i, s in sd["state"].items()}
    return sd
