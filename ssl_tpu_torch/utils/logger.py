"""Logging: message logger, tensorboard, timers (reference: utils/logger.py).

Counterpart of ``ssl_tpu/utils/logger.py``: the same log line (iteration,
learning rate, eta, iteration and data time, every loss), ``AvgTimer`` and
``get_root_logger``.  ``get_env_info`` reports torch, CUDA and the card."""

from __future__ import annotations

import datetime
import logging
import time

LOGGER_NAME = "ssl_tpu_torch"


class AvgTimer:
    """Sliding-average iteration/data timer (reference logger.py:10-43)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """Console/training-log formatter (reference logger.py:45-115):
    [name..][epoch, iter, lr] [eta, time (data)] l_*: values"""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt.get("logger") or {}
        self.interval = logger_opt.get("print_freq", 100)
        self.start_iter = start_iter
        self.max_iters = (opt.get("train") or {}).get("total_iter", 0)
        self.use_tb_logger = logger_opt.get("use_tb_logger", False)
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self):
        self.start_time = time.time()

    def __call__(self, log_vars: dict):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch", 0)
        lrs = log_vars.pop("lrs", [])

        message = f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += ",".join(f"{v:.3e}" for v in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None and self.use_tb_logger:
                tag = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(tag, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A tensorboardX writer; ``logger.use_tb_logger`` needs the package."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise ImportError("logger.use_tb_logger is on but tensorboardX is not installed; "
                          "install it or set use_tb_logger: false") from e
    return SummaryWriter(log_dir=log_dir)


def get_root_logger(logger_name: str = LOGGER_NAME, log_level=logging.INFO,
                    log_file: str | None = None):
    """The package's logger: one console handler, and a file handler for
    ``log_file`` (a later ``log_file`` replaces the earlier one)."""
    logger = logging.getLogger(logger_name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
        logger.setLevel(log_level)
    if log_file is not None:
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_env_info() -> str:
    import torch
    cuda = torch.cuda.is_available()
    card = torch.cuda.get_device_name(0) if cuda else "none"
    return ("\nVersion Information:"
            f"\n\ttorch: {torch.__version__}"
            f"\n\tCUDA: {torch.version.cuda} (available: {cuda})"
            f"\n\tcard: {card}")
