"""The port's option parsing and logger against ssl_tpu's: the shipped
ESRGAN-SSL train and test YAMLs and a .json copy give JAX's dict;
--force_yml, --auto_resume and --debug act alike; --device is parsed; what
is not ported raises; the training log line is JAX's."""

import json
import logging
import os
import sys

import pytest
import yaml

from ssl_tpu.utils import logger as jlogger
from ssl_tpu.utils import options as jopt
from ssl_tpu_torch.utils import logger as tlogger
from ssl_tpu_torch.utils import options as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YML = os.path.join(REPO, "options", "train", "ESRGANSSL", "train_ESRGANSSL_bicubic_x4.yml")
TEST_YML = os.path.join(REPO, "options", "test", "ESRGANSSL", "test_ESRGANSSL_bicubic_x4.yml")


def _json_copy(yml, tmp_path):
    with open(yml) as f:
        opt = yaml.safe_load(f)
    path = os.path.join(tmp_path, os.path.basename(yml)[:-4] + ".json")
    with open(path, "w") as f:
        f.write("// the shipped options as JSON\n" + json.dumps(opt, indent=1))
    return path


def _paths_rebased(opt, old_root, new_root):
    return {k: v.replace(old_root, new_root, 1) if isinstance(v, str) else v
            for k, v in opt["path"].items()}


@pytest.mark.parametrize("yml, is_train", [(TRAIN_YML, True), (TEST_YML, False)])
@pytest.mark.parametrize("fmt", ["yaml", "json"])
def test_shipped_options_match_jax(yml, is_train, fmt, tmp_path):
    path = yml if fmt == "yaml" else _json_copy(yml, str(tmp_path))
    want, _ = jopt.parse_options("/exp", is_train=is_train, args=["-opt", yml])
    got, parsed = topt.parse_options("/exp", is_train=is_train, args=["-opt", path,
                                                                       "--device", "cpu"])
    assert got == want
    assert parsed.device == "cpu"
    # under another root only the experiment / result paths move
    other, _ = topt.parse_options("/elsewhere", is_train=is_train,
                                  args=["-opt", path, "--device", "cpu"])
    assert other["path"] == _paths_rebased(want, "/exp", "/elsewhere")
    assert {k: v for k, v in other.items() if k != "path"} == \
        {k: v for k, v in want.items() if k != "path"}


@pytest.mark.parametrize("extra", [
    ["--auto_resume"],
    ["--debug"],
    ["--force_yml", "train:total_iter=6", "logger:print_freq=1", "val:metrics:psnr:crop_border=2",
     "datasets:train:gt_size=96", "new_key:sub=[1, 2]"],
])
def test_switches_match_jax(extra):
    want, jparsed = jopt.parse_options("/r", True, ["-opt", TRAIN_YML] + extra)
    got, tparsed = topt.parse_options("/r", True, ["-opt", TRAIN_YML, "--device", "cpu"] + extra)
    assert got == want
    assert (tparsed.auto_resume, tparsed.debug) == (jparsed.auto_resume, jparsed.debug)


def test_force_yml_without_yaml(monkeypatch):
    """No yaml: values parse as JSON, else stay strings (a .json file needs none)."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    opt = {}
    for entry in ("a:b=6", "a:c=[1, 2]", "a:d=word", "a:e=true"):
        topt.set_by_dotted(opt, entry)
    assert opt == {"a": {"b": 6, "c": [1, 2], "d": "word", "e": True}}


def test_device_defaults_to_cuda():
    _, parsed = topt.parse_options("/r", True, ["-opt", TRAIN_YML, "--force_yml", "num_devices=1"])
    assert parsed.device == "cuda"


def test_unported_switches_raise(tmp_path):
    """Several cards need torchrun: num_devices > 1 in one process raises and
    names the command; --launcher takes pytorch, and jax as its alias."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m ssl_tpu_torch.train"):
        topt.parse_options("/r", True, ["-opt", TRAIN_YML, "--device", "cpu",
                                        "--force_yml", "num_devices=2"])
    for launcher in ("jax", "pytorch"):
        _, parsed = topt.parse_options("/r", True, ["-opt", TRAIN_YML, "--device", "cpu",
                                                    "--launcher", launcher,
                                                    "--force_yml", "num_devices=2"])
        assert parsed.launcher == "pytorch"
    # KAIR files are ported: one parses to the JAX package's adapted dict
    kair = os.path.join(tmp_path, "kair.json")
    with open(kair, "w") as f:
        json.dump({"name": "k", "netG": {"net_type": "rrdbnet"}}, f)
    got, _ = topt.parse_options("/r", True, ["-opt", kair, "--device", "cpu"])
    want, _ = jopt.parse_options("/r", True, ["-opt", kair])
    assert got == want and got["model_type"] == "BSRGANSSLModel"


def test_dict2str_and_copy_opt_file_match_jax(tmp_path):
    opt, _ = topt.parse_options("/r", True, ["-opt", TRAIN_YML, "--device", "cpu"])
    assert topt.dict2str(opt) == jopt.dict2str(opt)
    topt.copy_opt_file(TRAIN_YML, str(tmp_path))
    with open(os.path.join(tmp_path, os.path.basename(TRAIN_YML))) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("# GENERATE TIME:")
    with open(TRAIN_YML) as f:
        assert lines[4:] == f.read().splitlines()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.mark.parametrize("with_time", [True, False])
def test_message_logger_line_matches_jax(with_time):
    opt = {"name": "ESRGANSSL_bicubic_x4", "logger": {"print_freq": 1},
           "train": {"total_iter": 10}}
    lines = {}
    for name, mod in (("jax", jlogger), ("torch", tlogger)):
        handler = _Lines()
        mod.get_root_logger().addHandler(handler)
        try:
            log_vars = {"iter": 3, "epoch": 1, "lrs": [1e-4], "l_pix": 0.0123,
                        "l_selfsim": 2.5, "l_d_real": 1e-5}
            if with_time:
                log_vars.update(time=0.61234, data_time=0.0009)
            mod.MessageLogger(opt, start_iter=0)(log_vars)
        finally:
            mod.get_root_logger().removeHandler(handler)
        lines[name] = handler.lines
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 1
    assert "l_selfsim: 2.5000e+00" in lines["torch"][0]


def test_timer_and_tb_logger(tmp_path, monkeypatch):
    timer = tlogger.AvgTimer()
    for _ in range(3):
        timer.record()
    assert timer.count == 3 and timer.get_avg_time() >= 0
    writer = tlogger.init_tb_logger(str(tmp_path / "tb"))
    writer.close()
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="use_tb_logger"):
        tlogger.init_tb_logger(str(tmp_path / "tb2"))
    assert "torch" in tlogger.get_env_info()
