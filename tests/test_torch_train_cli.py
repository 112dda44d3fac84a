"""The port's train CLI against ssl_tpu's: with num_worker_per_gpu 0, one
seed and the same G .pth given to both, iteration 1's logged l_pix,
l_selfsim and l_selfsim_kl agree within rtol 1e-4 (the train step's
tolerance, tests/test_torch_train_step.py): both draw the same crops and
flips, and the G losses of the first step depend on G and the batch only.

Tiny ESRGAN-SSL without a D (RRDBNet nf 8 / nb 1 / gc 4, gt 32, batch 2, SSL
search 9 / window 5), one iteration, no validation."""

import os

import numpy as np
import pytest
import torch

import ssl_tpu.train as jcli
import ssl_tpu_torch.train as tcli
from ssl_tpu.utils import logger as jlogger
from ssl_tpu_torch.archs import RRDBNet
from ssl_tpu_torch.utils import logger as tlogger
from torch_cli_cases import G_OPT, train_opt, write_dataset, write_json

LOGGED = ("l_pix", "l_selfsim", "l_selfsim_kl")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the suite runs several test processes on the
    machine's cores, and torch's thread pools contending for them slow this
    file's many small CPU ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(monkeypatch, logger_cls):
    seen = []
    call = logger_cls.__call__

    def record(self, log_vars):
        seen.append(dict(log_vars))
        return call(self, log_vars)
    monkeypatch.setattr(logger_cls, "__call__", record)
    return seen


def test_first_iteration_losses_match_jax_cli(tmp_path, monkeypatch):
    root = str(tmp_path)
    d = write_dataset(os.path.join(root, "data"), n_train=4)
    g = RRDBNet(**{k: v for k, v in G_OPT.items() if k != "type"})
    g.reset_parameters(torch.Generator().manual_seed(3))
    weights = os.path.join(root, "g.pth")
    torch.save({"params": g.state_dict()}, weights)

    runs = {}
    for name, cli, logger_cls, extra in (
            ("torch", tcli, tlogger.MessageLogger, ["--device", "cpu"]),
            ("jax", jcli, jlogger.MessageLogger, [])):
        opt = train_opt(d, name=f"first_{name}", gt_size=32, d_net=False, workers=0,
                        total_iter=1, path={"pretrain_network_g": weights,
                                            "param_key_g": "params"})
        opt["val"]["val_freq"] = opt["logger"]["save_checkpoint_freq"] = 100
        seen = _recording(monkeypatch, logger_cls)
        cli.train_pipeline(root, ["-opt", write_json(opt, os.path.join(root, f"{name}.json"))]
                           + extra)
        assert [s["iter"] for s in seen] == [1]
        runs[name] = seen[0]
        monkeypatch.undo()

    for k in LOGGED:
        assert np.isfinite(runs["torch"][k])
        np.testing.assert_allclose(runs["torch"][k], runs["jax"][k], rtol=1e-4, err_msg=k)
    assert runs["torch"]["l_selfsim"] > 0
    assert runs["torch"]["lrs"] == pytest.approx(runs["jax"]["lrs"])
