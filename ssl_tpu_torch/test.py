"""Testing/eval pipeline CLI (reference surface: basicsr/test.py).

    python -m ssl_tpu_torch.test -opt options/test/ESRGANSSL/test_ESRGANSSL_bicubic_x4.yml

Counterpart of ``ssl_tpu/test.py``: the ``is_train: false`` model (G from
``path.pretrain_network_g``, no losses, no optimizer, no D) over every test
set, with the option file's metrics and saved images.  Runs on ``cuda``
unless ``--device`` names another device.  Under ``torchrun`` with
``--launcher pytorch`` (``ssl_tpu/test.py``'s ``--launcher jax``) every rank
runs every image and rank 0 scores, logs and writes them:

    torchrun --nproc_per_node 2 -m ssl_tpu_torch.test -opt <file> --launcher pytorch"""

from __future__ import annotations

import logging
import os
import time

import torch

from ssl_tpu_torch.data import build_dataloader, build_dataset
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.models.base_model import resolve_device
from ssl_tpu_torch.parallel.mesh import init_distributed, is_main
from ssl_tpu_torch.utils.logger import get_env_info, get_root_logger
from ssl_tpu_torch.utils.options import dict2str, parse_options


def test_pipeline(root_path: str, args=None) -> dict:
    """Run the CLI with ``args`` (``sys.argv`` when None) under ``root_path``;
    returns the metrics by test set."""
    opt, parsed = parse_options(root_path, is_train=False, args=args)
    device = resolve_device(parsed.device)
    opt["dist"] = parsed.launcher == "pytorch"
    if opt["dist"]:
        device = init_distributed(device)

    os.makedirs(opt["path"]["results_root"], exist_ok=True)
    if is_main():
        log_file = os.path.join(opt["path"]["log"], f"test_{opt['name']}_{int(time.time())}.log")
        logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    else:
        logger = get_root_logger()
        logger.setLevel(logging.ERROR)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt, device=device))
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt, device=device)
    state = model.init_state()

    results = {}
    for test_loader in test_loaders:
        test_set_name = test_loader.dataset.opt["name"]
        logger.info(f"Testing {test_set_name}...")
        metrics = model.validation(state, test_loader, current_iter=opt["name"],
                                   tb_logger=None,
                                   save_img=(opt.get("val") or {}).get("save_img", True))
        logger.info(f"Results [{test_set_name}]: {metrics}")
        results[test_set_name] = metrics
    return results


def main():
    test_pipeline(os.getcwd())
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
