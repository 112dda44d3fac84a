"""Fixtures shared by the CLI parity tests: a tiny paired dataset on disk and
option dicts for the ESRGAN-SSL train and test CLIs at a small size
(RRDBNet nf 8 / nb 1 / gc 4; SSL search 9, window 5)."""

import json
import os

import cv2
import numpy as np
from scipy.io import savemat

G_OPT = {"type": "RRDBNet", "num_in_ch": 3, "num_out_ch": 3, "num_feat": 8, "num_block": 1,
         "num_grow_ch": 4}
D_OPT = {"type": "VGGStyleDiscriminator", "num_in_ch": 3, "num_feat": 4, "input_size": 128}
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 4, "test_y_channel": True},
           "ssim": {"type": "calculate_ssim", "crop_border": 4, "test_y_channel": True}}
# val LQ sizes: neither side of the second is a multiple of 16
VAL_LQ = ((16, 20), (13, 22))


def _picture(h, w, rng):
    """Smooth colour fields with a bright block and a dark step (edges for
    the mask), uint8 BGR."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(7 * yy) * 0.3 + 0.5, xx * yy + 0.2, np.cos(5 * (xx + yy)) * 0.3 + 0.5],
                   -1) + rng.randn(h, w, 3) * 0.03
    img[h // 5:h // 2, w // 4:w // 2] = 0.9
    img[2 * h // 3:, 3 * w // 5:] = 0.1
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_dataset(root, n_train=4, gt=128, scale=4, seed=0):
    """gt/, lq/ (INTER_AREA x1/scale), mask/ (.mat, Laplacian > 20 of GT) and
    vgt/, vlq/ (the VAL_LQ pairs); returns the folders by name."""
    from ssl_tpu_torch.ops.edge_mask import edge_mask_np
    rng = np.random.RandomState(seed)
    d = {k: os.path.join(root, k) for k in ("gt", "lq", "mask", "vgt", "vlq")}
    for p in d.values():
        os.makedirs(p, exist_ok=True)
    for i in range(n_train):
        img = _picture(gt, gt, rng)
        cv2.imwrite(os.path.join(d["gt"], f"img{i}.png"), img)
        lq = cv2.resize(img, (gt // scale, gt // scale), interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(d["lq"], f"img{i}.png"), lq)
        mask = edge_mask_np(img[..., ::-1], threshold=20.0)
        savemat(os.path.join(d["mask"], f"img{i}.mat"), {"mat": mask.astype(np.float64)})
    for i, (h, w) in enumerate(VAL_LQ):
        img = _picture(h * scale, w * scale, rng)
        cv2.imwrite(os.path.join(d["vgt"], f"v{i}.png"), img)
        lq = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(d["vlq"], f"v{i}.png"), lq)
    return d


def train_opt(d, name="tiny_cli", gt_size=128, d_net=True, workers=0, total_iter=3, **extra):
    opt = {
        "name": name, "model_type": "ESRGANSSLModel", "scale": 4, "num_devices": 1,
        "manual_seed": 0,
        "datasets": {
            "train": {"name": "synth", "type": "PairedImageMaskDataset", "dataroot_gt": d["gt"],
                      "dataroot_lq": d["lq"], "dataroot_gt_mask": d["mask"], "gt_size": gt_size,
                      "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 2,
                      "num_worker_per_gpu": workers, "dataset_enlarge_ratio": 1},
            "val": {"name": "synthval", "type": "PairedImageDataset", "dataroot_gt": d["vgt"],
                    "dataroot_lq": d["vlq"], "io_backend": {"type": "disk"}}},
        "network_g": dict(G_OPT),
        "path": {"pretrain_network_g": None},
        "ssl_setting": {"mask_stride": 3, "impl": "dense", "kernel_size_search": 9,
                        "sigma": 0.004, "kernel_size_window": 5, "generalization": True},
        "train": {
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0, "betas": [0.9, 0.99]},
            "scheduler": {"type": "MultiStepLR", "milestones": [2], "gamma": 0.5},
            "total_iter": total_iter, "warmup_iter": -1,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2, "reduction": "mean"},
            "selfsim_opt": {"type": "L1Loss", "loss_weight": 1e3, "reduction": "mean"},
            "selfsim1_opt": {"type": "KLDistanceLoss", "loss_weight": 1e3, "reduction": "mean",
                             "softmax": False},
            "gan_opt": {"type": "GANLoss", "gan_type": "vanilla", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 5e-3},
            "net_d_iters": 1, "net_d_init_iters": 0},
        "val": {"val_freq": total_iter, "save_img": True, "metrics": METRICS},
        "logger": {"print_freq": 1, "save_checkpoint_freq": total_iter, "use_tb_logger": False},
    }
    if d_net:
        opt["network_d"] = dict(D_OPT)
    else:
        del opt["train"]["optim_d"], opt["train"]["gan_opt"]
    opt.update(extra)
    return opt


def eval_opt(d, weights, name="tiny_test", **extra):
    return dict({"name": name, "model_type": "ESRGANSSLModel", "scale": 4, "num_devices": 1,
                 "manual_seed": 0,
                 "datasets": {"test_1": {"name": "synthval", "type": "PairedImageDataset",
                                         "dataroot_gt": d["vgt"], "dataroot_lq": d["vlq"]}},
                 "network_g": dict(G_OPT),
                 "path": {"pretrain_network_g": weights, "param_key_g": "params_ema"},
                 "val": {"save_img": True, "metrics": METRICS}}, **extra)


def write_json(opt, path):
    with open(path, "w") as f:
        json.dump(opt, f, indent=1)
    return path
