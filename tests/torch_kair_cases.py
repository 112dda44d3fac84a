"""Shared pieces of the KAIR/BSRGAN-SSL parity tests: the shipped KAIR
files, a tiny KAIR-schema option dict over ``torch_cli_cases.write_dataset``'s
folders (BSRGANRRDBNet nf 8 / nb 1 / gc 4, UNetDiscriminatorSN nf 4,
H_size 32 so LQ 8, SSL search 9 / window 5 at sigma 0.1 with the shipped
mask_stride 3, lsgan, E_decay 0.999), and a writer for it."""

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAIR_RECIPES = ("BSRGANSSL", "ELANGANSSL_BSRGAN", "SwinIRGANSSL_BSRGAN")


def shipped(kind: str, recipe: str) -> str:
    """options/train/<recipe>/train_<recipe>_DF2K_OST_x4.json or its test YAML."""
    ext = "json" if kind == "train" else "yml"
    return os.path.join(REPO, "options", kind, recipe, f"{kind}_{recipe}_DF2K_OST_x4.{ext}")


def tiny_kair(d: dict, name: str, iterations: int = 3, workers: int = 0, batch: int = 2,
              perceptual: bool = True, pretrained_g=None, **train) -> dict:
    """A KAIR-schema option dict (as the shipped .json files hold) at tiny
    widths over the folders of ``torch_cli_cases.write_dataset``."""
    return {
        "task": name, "model": "SSL", "scale": 4, "seed": 0,
        "path": {"root": "experiments", "pretrained_netG": pretrained_g, "pretrained_netD": None},
        "datasets": {
            "train": {"name": "synth", "dataset_type": "blindsrmask", "dataroot_H": d["gt"],
                      "dataroot_H_mask": d["mask"], "degradation_type": "bsrgan", "H_size": 32,
                      "lq_patchsize": 8, "dataloader_num_workers": workers,
                      "dataloader_batch_size": batch},
            "test": {"name": "synthval", "dataset_type": "sr", "dataroot_H": d["vgt"],
                     "dataroot_L": d["vlq"]}},
        "netG": {"net_type": "rrdbnet", "in_nc": 3, "out_nc": 3, "nf": 8, "nb": 1, "gc": 4},
        "netD": {"net_type": "discriminator_unet", "base_nc": 4},
        "train": {
            "G_lossfn_type": "l1", "G_lossfn_weight": 1,
            "F_lossfn_type": "l1", "F_lossfn_weight": 1 if perceptual else 0,
            "F_feature_layer": [2, 7, 16, 25, 34], "F_weights": [0.1, 0.1, 1.0, 1.0, 1.0],
            "F_use_input_norm": True, "F_use_range_norm": False,
            "gan_type": "lsgan", "D_lossfn_weight": 1, "E_decay": 0.999, "D_init_iters": 0,
            "G_optimizer_type": "adam", "G_optimizer_lr": 1e-4, "G_optimizer_wd": 0,
            "D_optimizer_type": "adam", "D_optimizer_lr": 1e-4, "D_optimizer_wd": 0,
            "G_scheduler_type": "MultiStepLR", "G_scheduler_milestones": [2],
            "G_scheduler_gamma": 0.5, "checkpoint_test": 1000, "checkpoint_save": 2,
            "checkpoint_print": 1, "iterations": iterations, "mask_stride": 3,
            "SSL_loss_weight": 500, "SSL_loss_type": "l1", "ssl_mode": "cuda",
            "kernel_size_search": 9, "sigma": 0.1, "generalization": True,
            "kernel_size_window": 5, "SSL1_loss_weight": 500, "SSL1_loss_type": "kl", **train}}


def write_json(obj: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path
