"""KAIR JSON option adapter (reference surface: train_BSGRAN/main_train_SSL.py
+ utils/utils_option.py).

A copy of ``ssl_tpu/utils/kair_options.py``: it translates the KAIR schema
(netG/netD, G_optimizer_*, E_decay, SSL_loss_*, dataset_type 'blindsrmask',
...) into the option dict the JAX package builds, key for key, so
``python -m ssl_tpu_torch.train -opt train_BSRGANSSL_DF2K_OST_x4.json`` trains
what ``python -m ssl_tpu.train`` trains from that file.  That includes its
``netG`` handling: only the RRDB and MSRResNet nets take the file's widths,
and ``swinir`` / ``elan`` give the bare type (the arch's defaults)."""

from __future__ import annotations


_NETG_MAP = {
    "rrdbnet": "BSRGANRRDBNet",
    # net_type 'rrdb' (network_rrdb.py) is the classic flat ESRGAN graph —
    # forward-equal to BSRGANRRDBNet through convert_old_rrdbnet
    # (test_kair_extra.py); gc hardcoded 32 there (network_rrdb.py:29)
    "rrdb": "BSRGANRRDBNet",
    "srresnet0": "KAIRMSRResNet0",
    "srresnet1": "MSRResNet",       # MSRResNet1 == basicsr MSRResNet
    "msrresnet0": "KAIRMSRResNet0",
    "msrresnet1": "MSRResNet",
    "elan": "ELAN",
    "swinir": "SwinIR",
}
# select_network.py also lists dncnn/fdncnn/ffdnet/srmd/dpsr/imdn/usrnet/
# drunet/vrt/rvrt, but their models/network_*.py files are ABSENT from the
# reference checkout — selecting them raises ImportError there; N/A here.
# Likewise the KAIR model keys 'plain2'/'plain4'/'vrt' (select_model.py:15-25)
# exist only to feed those absent nets (L+C / L+k+sf+sigma inputs); the
# reachable keys 'SSL'/'gan'/'plain' are mapped below.

_NETD_MAP = {
    "discriminator_unet": "UNetDiscriminatorSN",   # same rosinality design
    "discriminator_vgg_192": "KAIRDiscriminatorVGG192",
    "discriminator_vgg_128": "KAIRDiscriminatorVGG128",
    "discriminator_vgg_96": "KAIRDiscriminatorVGG96",
    "discriminator_vgg_128_SN": "KAIRDiscriminatorVGG128SN",
    "discriminator_patchgan": "KAIRDiscriminatorPatchGAN",
}

_GAN_TYPE_MAP = {"gan": "vanilla", "ragan": "vanilla", "lsgan": "lsgan",
                 "wgan": "wgan", "softplusgan": "wgan_softplus"}


def _make_network_d(netd: dict) -> dict:
    d_type = _NETD_MAP.get(netd.get("net_type", "discriminator_unet"),
                           "UNetDiscriminatorSN")
    if d_type == "KAIRDiscriminatorPatchGAN":
        return {"type": d_type, "ndf": netd.get("base_nc", 64),
                "n_layers": netd.get("n_layers", 3),
                "norm_type": netd.get("norm_type", "spectral")}
    if d_type.startswith("KAIRDiscriminatorVGG") and not d_type.endswith("SN"):
        return {"type": d_type, "base_nc": netd.get("base_nc", 64)}
    if d_type == "KAIRDiscriminatorVGG128SN":
        return {"type": d_type}
    return {"type": d_type, "num_feat": netd.get("base_nc", 64)}


def is_kair_options(opt: dict) -> bool:
    return "netG" in opt or "dataset_type" in str(opt.get("datasets", {}))


def kair_to_opt(k: dict) -> dict:
    """Convert a parsed KAIR JSON dict to the framework option schema."""
    t = k.get("train", {})
    scale = k.get("scale", 4)
    netg = k.get("netG", {})
    netd = k.get("netD", {})
    ds_train = (k.get("datasets") or {}).get("train", {})
    ds_test = (k.get("datasets") or {}).get("test", {})

    g_type = _NETG_MAP.get(netg.get("net_type", "rrdbnet"), "BSRGANRRDBNet")
    network_g = {"type": g_type}
    if netg.get("net_type") == "rrdb":
        # network_rrdb.py:29 hardcodes gc=32 in the body regardless of config
        network_g.update(in_nc=netg.get("in_nc", 3), out_nc=netg.get("out_nc", 3),
                         nf=netg.get("nc", netg.get("nf", 64)),
                         nb=netg.get("nb", 23), gc=32, sf=scale)
    elif g_type == "BSRGANRRDBNet":
        network_g.update(in_nc=netg.get("in_nc", 3), out_nc=netg.get("out_nc", 3),
                         nf=netg.get("nf", 64), nb=netg.get("nb", 23),
                         gc=netg.get("gc", 32), sf=scale)
    elif g_type == "MSRResNet":
        network_g.update(num_feat=netg.get("nf", 64), num_block=netg.get("nb", 16),
                         upscale=scale)
    elif g_type == "KAIRMSRResNet0":
        network_g.update(nc=netg.get("nc", netg.get("nf", 64)),
                         nb=netg.get("nb", 16), upscale=scale)

    # KAIR model key -> recipe: "SSL" (main_train_SSL.py, every shipped
    # config), "gan" (main_train_gan.py ModelGAN = BSRGAN recipe without the
    # SSL terms) and "plain" (main_train_psnr.py ModelPlain = G-only PSNR)
    model_map = {"SSL": "BSRGANSSLModel", "gan": "SRGANModel",
                 "plain": "SRModel"}
    opt = {
        "name": k.get("task", "kair_ssl"),
        "model_type": model_map.get(k.get("model", "SSL"), "BSRGANSSLModel"),
        "scale": scale,
        "manual_seed": k.get("seed", 0),
        "tile_process": k.get("tile_process", False),
        "tile_size": k.get("tile_size", 400),
        "tile_pad": k.get("tile_pad", 32),
        "datasets": {
            "train": {
                "name": ds_train.get("name", "train"),
                "type": "DatasetBlindSRMask",
                "dataroot_gt": ds_train.get("dataroot_H"),
                "dataroot_gt_mask": ds_train.get("dataroot_H_mask"),
                "H_size": ds_train.get("H_size", 256),
                "gt_size": ds_train.get("H_size", 256),
                "batch_size_per_gpu": ds_train.get("dataloader_batch_size", 16),
                "num_worker_per_gpu": ds_train.get("dataloader_num_workers", 4),
            },
            "val": {
                "name": ds_test.get("name", "test"),
                "type": "PairedImageDataset",
                "dataroot_gt": ds_test.get("dataroot_H"),
                "dataroot_lq": ds_test.get("dataroot_L"),
            },
        },
        "network_g": network_g,
        "network_d": _make_network_d(netd),
        "path": {
            "pretrain_network_g": (k.get("path") or {}).get("pretrained_netG"),
            "pretrain_network_d": (k.get("path") or {}).get("pretrained_netD"),
        },
        "ssl_setting": {
            "ssl_mode": t.get("ssl_mode", "cuda"),
            "kernel_size_search": t.get("kernel_size_search", 25),
            "kernel_size_window": t.get("kernel_size_window", 9),
            "sigma": t.get("sigma", 0.004),
            "generalization": t.get("generalization", True),
        },
        "train": {
            # KAIR reads train.mask_stride and APPLIES it (model_ssl.py:293) —
            # putting it here turns the lattice subsampling genuinely on
            "mask_stride": t.get("mask_stride", 0),
            "ema_decay": t.get("E_decay", 0.999),
            "optim_g": {"type": "Adam", "lr": t.get("G_optimizer_lr", 1e-4),
                        "weight_decay": t.get("G_optimizer_wd", 0)},
            "optim_d": {"type": "Adam", "lr": t.get("D_optimizer_lr", 1e-4),
                        "weight_decay": t.get("D_optimizer_wd", 0)},
            "scheduler": {"type": "MultiStepLR",
                          "milestones": t.get("G_scheduler_milestones", []),
                          "gamma": t.get("G_scheduler_gamma", 0.5)},
            "total_iter": t.get("iterations", 150000),
            "pixel_opt": {"type": {"l1": "L1Loss", "l2": "MSELoss",
                                   "l2sum": "MSELoss",
                                   "ssim": "SSIMLoss"}.get(
                t.get("G_lossfn_type", "l1"), "L1Loss"),
                "loss_weight": t.get("G_lossfn_weight", 1.0),
                **({"reduction": "sum"}
                   if t.get("G_lossfn_type") == "l2sum" else {})},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": t.get("SSL_loss_weight", 0)},
            "selfsim1_opt": {"type": "KLDistanceLoss",
                             "loss_weight": t.get("SSL1_loss_weight", 0)},
            "gan_opt": {"type": "GANLoss",
                        "gan_type": _GAN_TYPE_MAP.get(t.get("gan_type", "lsgan"), "lsgan"),
                        "loss_weight": t.get("D_lossfn_weight", 1.0)},
            "net_d_init_iters": t.get("D_init_iters", 0),
        },
        "val": {"val_freq": t.get("checkpoint_test", 1000), "save_img": k.get("save_test_image", False),
                "metrics": {"psnr": {"type": "calculate_psnr", "crop_border": scale,
                                     "test_y_channel": True}}},
        "logger": {"print_freq": t.get("checkpoint_print", 100),
                   "save_checkpoint_freq": t.get("checkpoint_save", 1000),
                   "use_tb_logger": False},
    }
    if t.get("F_lossfn_weight", 0) and t.get("F_feature_layer") is not None:
        layers = t.get("F_feature_layer")
        weights = t.get("F_weights", 1.0)
        if not isinstance(layers, list):
            layers, weights = [layers], [weights]
        # KAIR indexes torchvision vgg19.features; map to conv tap names
        idx2name = {2: "conv1_2", 7: "conv2_2", 16: "conv3_4", 25: "conv4_4", 34: "conv5_4"}
        layer_weights = {idx2name.get(i, "conv5_4"): w for i, w in zip(layers, weights)}
        opt["train"]["perceptual_opt"] = {
            "type": "PerceptualLoss", "layer_weights": layer_weights,
            "use_input_norm": t.get("F_use_input_norm", True),
            "range_norm": t.get("F_use_range_norm", False),
            "perceptual_weight": t.get("F_lossfn_weight", 1.0),
            "style_weight": 0, "criterion": t.get("F_lossfn_type", "l1"),
        }
    return opt
