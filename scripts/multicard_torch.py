"""The port's torch.distributed paths at several ranks against one rank, on
the same global batch: one process per card under torchrun.

    torchrun --standalone --nproc_per_node 4 scripts/multicard_torch.py
    # rehearsal on the CPU under gloo, at small widths:
    torchrun --standalone --nproc_per_node 4 scripts/multicard_torch.py --device cpu --small

Every rank steps on its rows of one seeded global batch; then rank 0 runs the
same steps alone on the whole batch (its model takes no process group) and
compares, with cuDNN deterministic and TF32 off. The world must be even.

1. ``ddp``: the ESRGAN-SSL step at the shipped widths (RRDBNet 64/23/32, the
   VGG-style D with its synced batch norm, VGG19 conv5_4, SSL 25/9/0.004),
   the shipped global batch of 16 (16 / W rows a rank), GT 128, 3 steps,
   against one rank and, as the control, one rank on the rows in reverse
   order: held after the first step (losses within rtol 1e-4; per net, the
   share of elements that moved more than lr / 5 apart at most twice the
   control's, plus 1e-6: see ``held``); the steps' losses, the largest
   differences and the elements with a gradient below 1e-5 of their net's
   largest reported; ms a step at W ranks and at one rank.
2. ``fsdp``: SRModel, RRDBNet 64/23/32 with its RRDBs sharded on a (W / 2,
   2) mesh, batch 8, 2 steps, held and reported as ``ddp``.
3. ``spatial``: MSRResNet 64/16 on a 339 x 510 LR with the height over the W
   ranks, halo 48, against the whole image, the rows that see the
   reflect-padded tail left out: within 1e-5 of the largest value.
4. ``tensor``: two StableSR-SSL mini-steps (ssl_base.yml's widths with
   ``num_res_blocks`` 1, 256^2, accumulate 2, 2 rows a data rank) on a (W / 2,
   2) data x model mesh with ZeRO-1: losses within rtol 1e-4, the first
   mini-step's gradients within 1e-3 relative L2, the update within 2.2 lr.

Prints one JSON line per check (rank 0), each with the card's name and power
limit, and last {"ok": ...}; exits 1 when a hold fails. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR_GAN, FLOOR = 1e-4, 1e-5


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", f"--id={device.index}"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        import torch
        return torch.cuda.get_device_name(device)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gan_opt(small: bool, model_type="ESRGANSSLModel", fsdp=1) -> dict:
    g = ({"num_feat": 8, "num_block": 2, "num_grow_ch": 4} if small else
         {"num_feat": 64, "num_block": 23, "num_grow_ch": 32})
    opt = {
        "name": "multicard", "model_type": model_type, "scale": 4, "manual_seed": 0,
        "datasets": {"train": {"gt_size": 128}},
        "network_g": {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, **g},
        "path": {}, "parallel": {"fsdp": fsdp, "fsdp_min_size": 32 if small else 2 ** 14},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": LR_GAN, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [400000], "gamma": 0.5},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"}}}
    if model_type == "ESRGANSSLModel":
        opt["network_d"] = {"type": "VGGStyleDiscriminator", "num_in_ch": 3,
                            "num_feat": 4 if small else 64, "input_size": 128}
        opt["ssl_setting"] = {"mask_stride": 3, "impl": "dense",
                              "kernel_size_search": 9 if small else 25,
                              "kernel_size_window": 5 if small else 9,
                              "sigma": 0.1 if small else 0.004, "generalization": True}
        opt["train"].update({
            "optim_d": dict(opt["train"]["optim_g"]),
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0})
        if not small:
            opt["train"]["perceptual_opt"] = {
                "type": "PerceptualLoss", "layer_weights": {"conv5_4": 1}, "vgg_type": "vgg19",
                "use_input_norm": True, "range_norm": False, "perceptual_weight": 1.0,
                "style_weight": 0, "criterion": "l1"}
    return opt


def gan_batch(b: int, device) -> dict:
    """Smooth seeded GT with a noisy 4x-down LQ, and an edge mask whose
    density changes along the batch (so that ranks count different edges)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(0)
    yy = torch.linspace(0, 1, 128)[:, None]
    xx = torch.linspace(0, 1, 128)[None]
    f = torch.rand(b, 3, 3, generator=gen) * 6 + 1
    gt = torch.stack([torch.stack([0.5 + 0.3 * torch.sin(f[i, c, 0] * yy + f[i, c, 1] * xx)
                                   * torch.cos(f[i, c, 2] * xx) for c in range(3)])
                      for i in range(b)])
    lq = F.avg_pool2d(gt, 4) + 0.02 * torch.randn(b, 3, 32, 32, generator=gen)
    density = torch.linspace(0.35, 0.1, b)[:, None, None, None]
    mask = (torch.rand(b, 1, 128, 128, generator=gen) < density).float()
    return {k: v.to(device) for k, v in (("lq", lq), ("gt", gt), ("gt_mask", mask))}


def snapshot(state) -> dict:
    from ssl_tpu_torch.parallel.fsdp import full_params
    nets = {"g": state.net_g, "g_ema": state.net_g_ema}
    if state.net_d is not None:
        nets["d"] = state.net_d
    return {k: [p.detach().clone() for p in full_params(n)] for k, n in nets.items()}


def floors_spy(counts: dict):
    """Count, per element, the steps at which its gradient was below FLOOR
    of its optimizer's largest (``models/srgan_model.py`` and
    ``sr_model.py`` call ``optimizer_step`` by these names); returns the
    function that takes the spy out."""
    import torch
    from ssl_tpu_torch.models import sr_model, srgan_model
    orig = srgan_model.optimizer_step

    def spy(opt, lr, apply=True):
        params = [p for g in opt.param_groups for p in g["params"] if p.grad is not None]
        if params:
            top = max(float(p.grad.abs().max()) for p in params)
            for p in params:
                c = counts.setdefault(id(p), torch.zeros_like(p, dtype=torch.int32))
                c += (p.grad.abs() < FLOOR * top).int()
        return orig(opt, lr, apply)
    srgan_model.optimizer_step = sr_model.optimizer_step = spy

    def restore():
        srgan_model.optimizer_step = sr_model.optimizer_step = orig
    return restore


def run_steps(opt, batch, n_steps, device, counts=None):
    """``n_steps`` of the recipe on ``batch``: the logs of each step (means
    over the ranks), ms a step after the first, and the nets and the noise
    counts by net after the first step and after the last."""
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.parallel.mesh import mean_over_ranks, shard_batch
    model = build_model(copy.deepcopy(opt), device=device)
    state = model.place_state(model.init_state(seed=0))
    local = shard_batch(batch, model.mesh)

    def noise():
        if counts is None:
            return None
        return {"g": [_clone(counts.get(id(p))) for p in state.net_g.parameters()],
                "d": [_clone(counts.get(id(p))) for p in state.net_d.parameters()]
                if state.net_d is not None else []}

    logs, t0, after = [], None, []
    for i in range(n_steps):
        if i == 1:
            sync(device)
            t0 = time.perf_counter()
        state, out = model.train_step(state, local)
        if model.mesh.distributed:          # rank 0's one-rank run takes no collective
            out = mean_over_ranks(out)
        logs.append({k: float(v) for k, v in out.items()})
        if i in (0, n_steps - 1):
            after.append((snapshot(state), noise()))
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / max(n_steps - 1, 1) if t0 else None
    return logs, ms, after[0], after[-1]


def _clone(t):
    return None if t is None else t.clone()


def weight_errors(got: dict, ref: dict, noisy: dict, lr: float) -> dict:
    """Per net: whether every element is within lr / 5 + 2.2 lr a noisy
    step of the reference, the largest difference, the share beyond lr / 5
    and the share of elements with a noisy step."""
    import torch
    out = {"ok": True, "max_abs": {}, "share_beyond_lr_over_5": {}, "noisy_share": {}}
    for net in ref:
        counts = noisy["d" if net == "d" else "g"]
        w = n_beyond = n_noisy = total = 0
        for i, (a, b) in enumerate(zip(ref[net], got[net])):
            cnt = counts[i] if counts[i] is not None else torch.zeros_like(a, dtype=torch.int32)
            diff = (a - b).abs()
            out["ok"] &= not bool((diff > lr / 5 + 2.2 * lr * cnt.to(a.dtype)).any())
            w = max(w, float(diff.max()))
            n_beyond += int((diff > lr / 5).sum())
            n_noisy += int((cnt > 0).sum())
            total += a.numel()
        out["max_abs"][net] = w
        out["share_beyond_lr_over_5"][net] = n_beyond / total
        out["noisy_share"][net] = n_noisy / total
    return out


def compare_steps(got, ref, lr) -> dict:
    """A run against the one-rank run: losses by step, and the weights after
    the first step and after the last (within lr / 5 plus 2.2 lr a noisy
    step; the shares beyond lr / 5)."""
    (g_logs, _, g_first, g_last), (r_logs, _, r_first, r_last) = got, ref
    loss_err = [max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-30) for k in a if k != "lr")
                for a, b in zip(r_logs, g_logs)]
    return {"loss_rel_err_by_step": loss_err,
            "after_step_1": weight_errors(g_first[0], r_first[0], r_first[1], lr),
            "after_last_step": weight_errors(g_last[0], r_last[0], r_last[1], lr)}


def permuted(batch: dict) -> dict:
    """The batch with its rows reversed: the same function of the rows, its
    sums over them taken in another order."""
    return {k: v.flip(0) for k, v in batch.items()}


def held(world: dict, control: dict) -> bool:
    """The W-rank run's first step against the one-rank run: losses within
    rtol 1e-4, and for each net a share of elements beyond lr / 5 at most
    twice (plus 1e-6) that of the control, a one-rank run on the rows in
    reverse order. Adam's first steps move an element by about lr with its
    gradient's sign, so a gradient whose sign the order of a sum decides
    moves by about 2 lr: the control measures how many such elements the
    order alone makes."""
    a, c = world["after_step_1"], control["after_step_1"]
    return world["loss_rel_err_by_step"][0] <= 1e-4 and all(
        a["share_beyond_lr_over_5"][n] <= 2 * c["share_beyond_lr_over_5"][n] + 1e-6 for n in a[
            "share_beyond_lr_over_5"])


def check_gan(args, device, rank, world, name, opt, batch, n_steps):
    """The W-rank run, then rank 0's one-rank run on the whole batch."""
    import torch.distributed as dist
    got = run_steps(opt, batch, n_steps, device)
    dist.barrier()
    out = None
    if rank == 0:
        counts = {}
        restore = floors_spy(counts)
        one = dict(copy.deepcopy(opt), dist=False)
        one["parallel"] = {}
        try:
            ref = run_steps(one, batch, n_steps, device, counts)
        finally:
            restore()
        control = compare_steps(run_steps(one, permuted(batch), n_steps, device), ref, LR_GAN)
        vs_world = compare_steps(got, ref, LR_GAN)
        out = {"check": name, "world": world, "global_batch": int(batch["lq"].shape[0]),
               "steps": n_steps, "ms_per_step": {"world": got[1], "one_rank": ref[1]},
               "ok": held(vs_world, control), "world_vs_one_rank": vs_world,
               "one_rank_reversed_vs_one_rank": control}
    dist.barrier()
    return out


def check_spatial(args, device, rank, world):
    import torch
    import torch.distributed as dist
    from ssl_tpu_torch.parallel.spatial import spatial_infer
    from ssl_tpu_torch.utils.registry import build_network
    g = ({"num_feat": 8, "num_block": 1} if args.small else {"num_feat": 64, "num_block": 16})
    net = build_network({"type": "MSRResNet", "upscale": 4, **g})
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(p[0].numel(), 1) ** 0.5)
    net = net.to(device).eval()
    h, w, halo = (250, 16, 16) if args.small else (339, 510, 48)
    img = torch.rand(1, 3, h, w, generator=gen).to(device)
    with torch.no_grad():
        sync(device)
        t0 = time.perf_counter()
        out = spatial_infer(net, img, 4, halo=halo)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
    dist.barrier()
    res = None
    if rank == 0:
        with torch.no_grad():
            sync(device)
            t0 = time.perf_counter()
            whole = net(img)
            sync(device)
            ms_one = 1e3 * (time.perf_counter() - t0)
        band = max(-(-h // world), 2 * halo)
        keep = h * 4 if band * world == h else (h - halo) * 4
        err = float((out[:, :, :keep] - whole[:, :, :keep]).abs().max())
        scale = float(whole.abs().max())
        res = {"check": "spatial", "world": world, "lr": [h, w], "halo": halo,
               "rows_held": keep, "max_abs_err": err, "of_largest": err / scale,
               "ms_first_call": {"world": ms, "one_rank": ms_one},
               "ok": tuple(out.shape) == tuple(whole.shape) and err <= 1e-5 * scale}
    dist.barrier()
    return res


def diffusion_cfg(small: bool, parallel=None) -> dict:
    if small:
        model = {"timesteps": 20, "context_dim": 32, "context_len": 4, "use_flash_attention": True,
                 "unet": {"model_channels": 32, "num_res_blocks": 1, "channel_mult": [1, 2],
                          "attention_resolutions": [1, 2], "num_heads": 4,
                          "num_head_channels": -1, "semb_channels": 32},
                 "structcond": {"model_channels": 32, "channel_mult": [1, 2], "out_channels": 32,
                                "num_res_blocks": 1, "num_heads": 4},
                 "first_stage": {"ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                                 "embed_dim": 4}}
        sslopt = {"kernel_size_search": 9, "kernel_size_window": 5, "sigma": 0.1, "mask_stride": 3}
    else:
        sys.path.insert(0, ROOT)
        import chip_smoke
        base = chip_smoke.ssl_base_cfg()
        model, sslopt = base["model"], base["sslopt"]
        model["unet"]["num_res_blocks"] = 1
    cfg = {"model": model, "sslopt": sslopt,
           "train": {"lr": 5e-5, "accumulate_grad_batches": 2}}
    if parallel:
        cfg["parallel"] = parallel
    return cfg


def diffusion_batch(b: int, size: int, device) -> dict:
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(30)
    gt = F.interpolate(torch.rand(b, 3, size // 8, size // 8, generator=gen), size=(size, size),
                       mode="bicubic", align_corners=False).clamp(0, 1)
    lq = F.interpolate(F.avg_pool2d(gt, 4), size=(size, size), mode="bicubic",
                       align_corners=False).clamp(0, 1)
    mask = (torch.rand(b, 1, size, size, generator=gen) < 0.25).float()
    return {k: v.to(device) for k, v in (("gt", gt), ("lq", lq), ("gt_mask", mask))}


def mini_steps(cfg, batch, device):
    """Two mini-steps from seeded weights (the zero layers drawn too): logs,
    the first one's gradients (whole), the update (whole), ms of the second."""
    import torch
    from ssl_tpu_torch.diffusion.ddpm_ssl import trainable
    from ssl_tpu_torch.diffusion.main import build_from_config
    from ssl_tpu_torch.parallel.mesh import mean_over_ranks, shard_batch
    from ssl_tpu_torch.parallel.tensor import NETS, gather_tp, trained_keys
    model = build_from_config(cfg)
    state = model.init_state(seed=0, device=device)
    with torch.no_grad():
        for tree in (state.params, state.ema_params):
            gen = torch.Generator(device=device).manual_seed(100)
            for net in NETS:
                for m in tree[net].modules():
                    if getattr(m, "zero_init", False):
                        m.weight.normal_(generator=gen).mul_(m.weight[0].numel() ** -0.5)
    start = [p.detach().clone() for p in trainable(state.params)]
    state = model.place_state(state)
    local = shard_batch(batch, model.mesh)
    keys = trained_keys(state.params)

    def whole(tensors):
        if model.plan is None:
            return [t.detach().clone() for t in tensors]
        m = model.mesh
        return [gather_tp(t.detach(), model.plan["params"][k], m.tp, m.inner_group).clone()
                for k, t in zip(keys, tensors)]

    state, first = model.train_step(state, local)
    grads = whole([torch.zeros_like(p) if p.grad is None else p.grad
                   for p in trainable(state.params)])
    if model.distributed:           # the gradients of the global batch: the data mean
        import torch.distributed as dist
        for g in grads:
            dist.all_reduce(g, group=model.mesh.data_group)
            g /= model.mesh.data
    sync(device)
    t0 = time.perf_counter()
    state, second = model.train_step(state, local)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    update = [p - s for p, s in zip(whole(trainable(state.params)), start)]
    logs = [{k: float(v) for k, v in (mean_over_ranks(x) if model.distributed else x).items()}
            for x in (first, second)]
    return logs, grads, update, ms


def check_tensor(args, device, rank, world):
    import torch.distributed as dist
    size = 64 if args.small else 256
    batch = diffusion_batch(world, size, device)           # 2 rows a data rank
    par = {"data": world // 2, "tp": 2, "zero": True, "zero_min_size": 128}
    got = mini_steps(diffusion_cfg(args.small, par), batch, device)
    dist.barrier()
    res = None
    if rank == 0:
        ref = mini_steps(diffusion_cfg(args.small), batch, device)
        log_err = max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-30)
                      for a, b in zip(ref[0], got[0]) for k in a)
        num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got[1], ref[1]))
        den = sum(float((b ** 2).sum()) for b in ref[1])
        grad_err = (num / den) ** 0.5
        update_err = max(float((a - b).abs().max()) for a, b in zip(got[2], ref[2]))
        res = {"check": "tensor", "world": world, "mesh": par, "size": size,
               "global_batch": world, "max_log_rel_err": log_err, "grad_rel_l2": grad_err,
               "max_update_abs_err": update_err,
               "ms_applying_mini_step": {"world": got[3], "one_rank": ref[3]},
               "ok": log_err <= 1e-4 and grad_err <= 1e-3 and update_err <= 2.2 * 5e-5}
    dist.barrier()
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true", help="small widths (a CPU rehearsal)")
    parser.add_argument("--timeout", type=float, default=600,
                        help="seconds a collective may wait before the run fails")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from ssl_tpu_torch.parallel.mesh import get_dist_info, init_distributed

    device = init_distributed(args.device, timeout=args.timeout)
    rank, world = get_dist_info()
    if world % 2:
        raise SystemExit("multicard_torch: the world size must be even")
    b = torch.backends
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    checks = (("ddp", lambda: check_gan(args, device, rank, world, "ddp", gan_opt(args.small),
                                        gan_batch(16, device), 3)),
              ("fsdp", lambda: check_gan(args, device, rank, world, "fsdp",
                                         gan_opt(args.small, "SRModel", fsdp=2),
                                         gan_batch(8, device), 2)),
              ("spatial", lambda: check_spatial(args, device, rank, world)),
              ("tensor", lambda: check_tensor(args, device, rank, world)))
    results = []
    for name, check in checks:
        t0 = time.perf_counter()
        results.append(check())
        if rank == 0:
            print(f"multicard_torch: {name} in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
    ok = True
    if rank == 0:
        name = card(device)
        for r in results:
            print(json.dumps({**r, "card": name}), flush=True)
            ok &= bool(r["ok"])
        print(json.dumps({"ok": ok, "world": world, "device": str(device.type)}), flush=True)
    flag = torch.tensor([int(ok)], device=device)
    torch.distributed.broadcast(flag, 0)
    torch.distributed.destroy_process_group()
    return 0 if bool(flag.item()) else 1


if __name__ == "__main__":
    sys.exit(main())
