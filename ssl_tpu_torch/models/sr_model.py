"""SRModel — the base SR training recipe (reference: models/sr_model.py).

Counterpart of ``ssl_tpu/models/sr_model.py``: pixel + optional perceptual
loss, Adam with a step schedule, EMA; inference with reflect padding or
tiles, and validation with the metric registry.  With ``is_train: false``
(the test CLI) the model builds no loss and no optimizer."""

from __future__ import annotations

import os
from copy import deepcopy

import numpy as np
import torch

from ssl_tpu_torch.archs.arch_util import pad_reflect
from ssl_tpu_torch.metrics import calculate_metric
from ssl_tpu_torch.models.base_model import (BaseModel, TrainState, build_optimizer,
                                             ema_update, load_network, optimizer_step)
from ssl_tpu_torch.models.lr_scheduler import build_schedule
from ssl_tpu_torch.utils.img_util import imwrite, tensor2img
from ssl_tpu_torch.utils.registry import MODEL_REGISTRY, build_loss


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device=device)
        train_opt = opt.get("train") or {}
        self.train_opt = train_opt
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.is_train:
            self.schedule_g = build_schedule(train_opt, train_opt["optim_g"].get("lr", 1e-4))
            self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
            self.cri_perceptual = (build_loss(train_opt["perceptual_opt"]).to(self.device)
                                   if train_opt.get("perceptual_opt") else None)
            if self.cri_pix is None and self.cri_perceptual is None:
                raise ValueError("Both pixel and perceptual losses are None.")
        self.best_metric_results: dict = {}

    # -------------------------------------------------------------- state init
    def init_state(self, seed: int = 0) -> TrainState:
        """G weights from a ``torch.Generator`` seeded with ``seed`` (or the
        configured pretrain file), Adam, and an EMA copy."""
        net_g = self.build_g()
        net_g.reset_parameters(torch.Generator().manual_seed(seed))
        path = (self.opt.get("path") or {})
        if path.get("pretrain_network_g"):
            load_network(net_g, path["pretrain_network_g"], path.get("param_key_g", "params"),
                         path.get("strict_load_g", True))
        net_g = net_g.to(self.device).train(self.is_train)
        opt_g = (build_optimizer(self.train_opt["optim_g"], net_g.parameters(), self.schedule_g)
                 if self.is_train else None)
        ema = None
        if self.ema_decay > 0:
            ema = deepcopy(net_g).requires_grad_(False)
        return TrainState(step=0, net_g=net_g, opt_g=opt_g, net_g_ema=ema)

    # ------------------------------------------------------------------ losses
    def g_losses(self, state: TrainState, batch: dict):
        sr = state.net_g(batch["lq"])
        total = sr.new_zeros(())
        logs = {}
        if self.cri_pix is not None:
            l_pix = self.cri_pix(sr, batch["gt"])
            total = total + l_pix
            logs["l_pix"] = l_pix
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(sr, batch["gt"])
            total = total + l_percep + l_style
            logs["l_percep"] = l_percep
        return total, logs, sr

    # -------------------------------------------------------------- train step
    def to_device(self, batch: dict) -> dict:
        return {k: (v.to(self.device) if torch.is_tensor(v) else v) for k, v in batch.items()}

    def make_train_step(self):
        def step_fn(state: TrainState, batch: dict):
            state.opt_g.zero_grad(set_to_none=True)
            total, logs, _ = self.g_losses(state, batch)
            total.backward()
            optimizer_step(state.opt_g, self.schedule_g(state.step))
            if self.ema_decay > 0:
                ema_update(state.net_g_ema, state.net_g, self.ema_decay)
            logs["l_total"] = total
            logs["lr"] = self.schedule_g(state.step)
            state.step += 1
            return state, {k: (v.detach() if torch.is_tensor(v) else v) for k, v in logs.items()}
        return step_fn

    def train_step(self, state: TrainState, batch: dict):
        """One optimization step; updates ``state`` in place and returns
        ``(state, logs)``."""
        return self.make_train_step()(state, self.to_device(batch))

    # --------------------------------------------------------------- inference
    def infer_net(self, state: TrainState):
        """The net inference runs (the JAX ``infer_params``): the EMA when
        there is one."""
        return state.net_g_ema if state.net_g_ema is not None else state.net_g

    def infer(self, net, lq: torch.Tensor) -> torch.Tensor:
        """The SR image of ``net`` on ``lq`` (SPSR takes one of its outputs)."""
        return net(lq)

    @torch.no_grad()
    def test(self, state: TrainState, lq: torch.Tensor) -> torch.Tensor:
        """SR of an (n, c, h, w) or (c, h, w) batch on the model's device:
        whole, reflect-padded at the bottom and right to a multiple of 16 (the
        JAX package's shape buckets), or in tiles with ``tile_process``.
        Reference: esrganssl_model.py test()/tile_process (:290-384)."""
        net = self.infer_net(state)
        lq = lq.to(self.device, torch.float32)
        if lq.dim() == 3:
            lq = lq[None]
        if self.opt.get("spatial_infer"):
            raise NotImplementedError("spatial_infer (multi-card halo exchange) is not ported "
                                      "yet (ROADMAP.md, queue 1 item 10)")
        if self.opt.get("tile_process"):
            return self.tile_process(net, lq)
        mult = 16
        h, w = lq.shape[-2:]
        sr = self.infer(net, pad_reflect(lq, (mult - h % mult) % mult, (mult - w % mult) % mult))
        return sr[:, :, : h * self.scale, : w * self.scale]

    def tile_process(self, net, lq: torch.Tensor) -> torch.Tensor:
        """Halo-overlap tiling (reference tile_process :290-356): tiles of
        ``tile_size`` with a ``tile_pad`` halo, each reflect-padded to the
        full padded-tile size, stitched from their centres."""
        tile_size = self.opt.get("tile_size", 400)
        tile_pad = self.opt.get("tile_pad", 32)
        scale = self.scale
        b, c, h, w = lq.shape
        out = lq.new_zeros((b, c, h * scale, w * scale))
        target = tile_size + 2 * tile_pad
        for y0 in range(0, h, tile_size):
            for x0 in range(0, w, tile_size):
                y1, x1 = min(y0 + tile_size, h), min(x0 + tile_size, w)
                yp0, xp0 = max(y0 - tile_pad, 0), max(x0 - tile_pad, 0)
                yp1, xp1 = min(y1 + tile_pad, h), min(x1 + tile_pad, w)
                tile = lq[:, :, yp0:yp1, xp0:xp1]
                th, tw = tile.shape[-2:]
                sr_tile = self.infer(net, pad_reflect(tile, target - th, target - tw))
                oy0, ox0 = (y0 - yp0) * scale, (x0 - xp0) * scale
                out[:, :, y0 * scale:y1 * scale, x0 * scale:x1 * scale] = \
                    sr_tile[:, :, oy0:oy0 + (y1 - y0) * scale, ox0:ox0 + (x1 - x0) * scale]
        return out

    # -------------------------------------------------------------- validation
    def validation(self, state: TrainState, dataloader, current_iter, tb_logger=None,
                   save_img=False) -> dict:
        """Per-image metrics on RGB uint8 (the reference's nondist_validation),
        averaged over the set; with ``save_img`` the SR images go to
        ``path.visualization/<set>/<name>_<iter>.png``."""
        dataset_name = dataloader.dataset.opt.get("name", "val")
        metric_opts = (self.opt.get("val") or {}).get("metrics") or {}
        results = {name: [] for name in metric_opts}
        for batch in dataloader:
            if batch["lq"].shape[0] != 1:
                raise ValueError(
                    f"validation expects batch_size_per_gpu=1 for val loaders, got "
                    f"{batch['lq'].shape[0]} (dataset {dataset_name!r})")
            sr = self.test(state, batch["lq"])
            # metrics take RGB uint8 (to_y_channel uses RGB coefficients);
            # only the saved file is BGR, as cv2.imwrite wants it
            sr_img = tensor2img(sr, rgb2bgr=False)
            gt_img = tensor2img(batch["gt"], rgb2bgr=False) if "gt" in batch else None
            if save_img:
                img_name = os.path.splitext(os.path.basename(batch["lq_path"][0]))[0]
                save_path = os.path.join(self.opt["path"]["visualization"], dataset_name,
                                         f"{img_name}_{current_iter}.png")
                imwrite(sr_img[..., ::-1] if sr_img.ndim == 3 else sr_img, save_path)
            for name, m_opt in metric_opts.items():
                if gt_img is not None:
                    results[name].append(calculate_metric({"img": sr_img, "img2": gt_img}, m_opt))
        avg = {name: float(np.mean(vals)) for name, vals in results.items() if vals}
        self._update_best(dataset_name, avg, current_iter, metric_opts)
        if tb_logger is not None:
            for name, val in avg.items():
                tb_logger.add_scalar(f"metrics/{dataset_name}/{name}", val, current_iter)
        return avg

    def _update_best(self, dataset_name, avg, current_iter, metric_opts):
        rec = self.best_metric_results.setdefault(dataset_name, {})
        for name, val in avg.items():
            better = (metric_opts.get(name) or {}).get("better", "higher")
            cur = rec.get(name)
            if cur is None or (better == "higher" and val > cur["val"]) or \
                    (better == "lower" and val < cur["val"]):
                rec[name] = {"val": val, "iter": current_iter}
