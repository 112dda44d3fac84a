"""Training pipeline CLI (reference surface: basicsr/train.py).

    python -m ssl_tpu_torch.train -opt options/train/ESRGANSSL/train_ESRGANSSL_bicubic_x4.yml

Counterpart of ``ssl_tpu/train.py``: parse the options -> seed -> data
loaders -> ``build_model`` -> init (or ``--auto_resume``) -> the iteration
loop, with a log line every ``print_freq``, checkpoints every
``save_checkpoint_freq``, validation every ``val_freq`` and a final save.
Runs on ``cuda`` unless ``--device`` names another device; one process, one
card.  The losses come to the host every iteration (as BasicSR's
``reduce_loss_dict`` does), so the iteration timer covers the card's work.

Several cards take one process each under ``torchrun`` with ``--launcher
pytorch`` (NCCL; gloo with ``--device cpu``):

    torchrun --nproc_per_node 4 -m ssl_tpu_torch.train -opt <file> --launcher pytorch

as ``ssl_tpu/train.py`` runs under ``--launcher jax``: the seed is
``manual_seed`` + the data rank, each rank loads its own
``batch_size_per_gpu`` rows (the global batch is that times the ``data``
width), the nets are wrapped for the mesh after init and resume
(``BaseModel.place_state``), the logged losses are means over the ranks,
and every rank enters the saves and validation while rank 0 alone logs and
writes files."""

from __future__ import annotations

import logging
import math
import os
import random
import time

import numpy as np
import torch

from ssl_tpu_torch.data import EnlargedSampler, build_dataloader, build_dataset, device_prefetch
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.models.base_model import resolve_device
from ssl_tpu_torch.parallel.mesh import init_distributed, mean_over_ranks, resolve_mesh
from ssl_tpu_torch.utils.logger import (AvgTimer, MessageLogger, get_env_info, get_root_logger,
                                        init_tb_logger)
from ssl_tpu_torch.utils.options import copy_opt_file, dict2str, parse_options


def create_train_val_dataloader(opt, logger, device, mesh=None):
    """The train loader (``EnlargedSampler`` over the ``data`` ranks,
    ``batch_size_per_gpu`` rows for this rank) and one loader per val set;
    returns them with the epoch and iteration counts."""
    mesh = mesh or resolve_mesh(opt)
    train_loader, val_loaders = None, []
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            dataset_enlarge_ratio = dataset_opt.get("dataset_enlarge_ratio", 1)
            train_set = build_dataset(dataset_opt)
            sampler = EnlargedSampler(len(train_set), mesh.data, mesh.data_rank,
                                      dataset_enlarge_ratio)
            train_loader = build_dataloader(train_set, dataset_opt, sampler=sampler,
                                            seed=opt["manual_seed"], device=device,
                                            rank=mesh.data_rank)
            if len(train_loader) == 0:
                raise ValueError(
                    f"dataset ({len(train_set)} imgs × enlarge {dataset_enlarge_ratio}) "
                    f"smaller than the batch {dataset_opt['batch_size_per_gpu']}: "
                    "set dataset_enlarge_ratio")
            num_iter_per_epoch = math.ceil(
                len(train_set) * dataset_enlarge_ratio /
                (dataset_opt["batch_size_per_gpu"] * mesh.data))
            total_iters = int(opt["train"]["total_iter"])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info("Training statistics:"
                        f"\n\tNumber of train images: {len(train_set)}"
                        f"\n\tBatch size per rank: {dataset_opt['batch_size_per_gpu']}"
                        f"\n\tData ranks: {mesh.data}; world size: {mesh.world}"
                        f"\n\tRequire iter per epoch: {num_iter_per_epoch}"
                        f"\n\tTotal epochs: {total_epochs}; iters: {total_iters}.")
        elif phase.split("_")[0] == "val":
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt, device=device))
        else:
            raise ValueError(f"Dataset phase {phase} is not recognized.")
    return train_loader, val_loaders, total_epochs, total_iters


def train_pipeline(root_path: str, args=None):
    """Run the CLI with ``args`` (``sys.argv`` when None) under ``root_path``;
    returns the final ``TrainState``."""
    opt, parsed = parse_options(root_path, is_train=True, args=args)
    device = resolve_device(parsed.device)
    opt["dist"] = parsed.launcher == "pytorch"      # a process group of the caller's is not used
    if opt["dist"]:
        device = init_distributed(device)
    mesh = resolve_mesh(opt)
    rank0 = mesh.rank == 0

    seed = opt["manual_seed"] + mesh.data_rank
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    for key in ("experiments_root", "models", "training_states"):
        os.makedirs(opt["path"][key], exist_ok=True)
    if rank0:
        copy_opt_file(parsed.opt, opt["path"]["experiments_root"])
        log_file = os.path.join(opt["path"]["log"],
                                f"train_{opt['name']}_{int(time.time())}.log")
        logger = get_root_logger(log_file=log_file)
    else:
        logger = get_root_logger()
        logger.setLevel(logging.ERROR)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = None
    if (opt.get("logger") or {}).get("use_tb_logger") and rank0:
        tb_logger = init_tb_logger(os.path.join(opt["path"]["experiments_root"], "tb_logger"))

    model = build_model(opt, device=device)
    train_loader, val_loaders, total_epochs, total_iters = \
        create_train_val_dataloader(opt, logger, device, mesh)
    state = model.init_state()

    start_epoch, current_iter = 0, 0
    if opt["path"].get("resume_state") or opt.get("auto_resume"):
        latest = model.find_latest_state(opt["path"]["training_states"])
        if latest is not None:
            state, current_iter = model.load_training_state(
                state, opt["path"]["training_states"], latest)
            logger.info(f"Resuming training from iter {current_iter}.")
            start_epoch = current_iter // max(len(train_loader), 1)
    state = model.place_state(state)      # DDP / FSDP under a process group

    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    logger.info(f"Start training from epoch: {start_epoch}, iter: {current_iter}")
    val_freq = (opt.get("val") or {}).get("val_freq")
    save_freq = (opt.get("logger") or {}).get("save_checkpoint_freq")
    print_freq = (opt.get("logger") or {}).get("print_freq", 100)

    epoch = start_epoch
    while current_iter < total_iters:
        train_loader.sampler.set_epoch(epoch)
        # a recipe that degrades on the host takes the loader's batches as they come
        batches = (train_loader if getattr(model, "degrades_on_host", False) else
                   device_prefetch(train_loader, device))
        for batch in batches:
            data_timer.record()
            if current_iter >= total_iters:
                break
            current_iter += 1
            if hasattr(model, "prepare_batch") and "lq" not in batch:
                batch = model.prepare_batch(batch)     # degradation recipes (ssl_tpu/train.py:165)
            state, logs = model.train_step(state, batch)
            host_logs = {k: float(v) for k, v in mean_over_ranks(logs).items()}
            iter_timer.record()
            if current_iter == 1:
                msg_logger.reset_start_time()
            if current_iter % print_freq == 0 and rank0:
                lr = host_logs.pop("lr", 0.0)
                msg_logger({"iter": current_iter, "epoch": epoch, "lrs": [lr],
                            "time": iter_timer.get_avg_time(),
                            "data_time": data_timer.get_avg_time(), **host_logs})
            if save_freq and current_iter % int(save_freq) == 0:
                logger.info("Saving models and training states.")
                model.save_networks(state, opt["path"]["models"], current_iter)
                model.save_training_state(state, opt["path"]["training_states"], epoch,
                                          current_iter)
            if val_freq and current_iter % int(val_freq) == 0:
                # every rank runs it (a sharded G's forward is collective);
                # rank 0 alone scores, logs and writes images
                for val_loader in val_loaders:
                    metrics = model.validation(state, val_loader, current_iter, tb_logger,
                                               (opt.get("val") or {}).get("save_img", False))
                    logger.info(f"Validation {val_loader.dataset.opt.get('name')}: {metrics}")
            data_timer.start()
            iter_timer.start()
        epoch += 1

    logger.info("End of training.")
    model.save_networks(state, opt["path"]["models"], current_iter)
    model.save_training_state(state, opt["path"]["training_states"], epoch, current_iter)
    if tb_logger is not None:
        tb_logger.close()
    return state


def main():
    train_pipeline(os.getcwd())
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
