"""Option parsing (reference public surface: basicsr/utils/options.py).

Counterpart of ``ssl_tpu/utils/options.py``: the same YAML schema, the same
``-opt``, ``--auto_resume``, ``--debug`` and ``--force_yml key:sub=val``
switches, the same experiment and result paths, KAIR ``.json`` files through
``utils/kair_options.py``, plus ``--device`` (``cuda``
unless the caller names another).  ``--launcher pytorch`` runs one process
per card under ``torchrun`` (``jax``, the JAX CLI's name, is an alias);
``--launcher none`` is one process, so a ``num_devices`` above 1 raises
there and names the ``torchrun`` command.  ``yaml`` is imported only to read a YAML
file: a ``.json`` option file (``//`` comments allowed) needs none, and
without ``yaml`` a ``--force_yml`` value is read as JSON, else kept as a
string."""

from __future__ import annotations

import argparse
import json
import os
import random
import re

from ssl_tpu_torch.utils.kair_options import is_kair_options, kair_to_opt

def ordered_yaml_load(path_or_str: str, from_file: bool = True) -> dict:
    if from_file:
        if path_or_str.endswith(".json"):
            return parse_json_options(path_or_str)
        import yaml
        with open(path_or_str, "r") as f:
            return yaml.safe_load(f)
    import yaml
    return yaml.safe_load(path_or_str)


def parse_json_options(path: str) -> dict:
    """JSON-with-//-comments options (KAIR tree surface:
    train_BSGRAN/utils/utils_option.py)."""
    with open(path) as f:
        txt = f.read()
    txt = re.sub(r"//[^\n\"]*", "", txt)
    return json.loads(txt)


def parse_value(val: str):
    """An override's value: read as YAML (as JSON without ``yaml``), else
    kept as the string."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(val)
        except ValueError:
            return val
    try:
        return yaml.safe_load(val)
    except yaml.YAMLError:
        return val


def set_by_dotted(opt: dict, dotted: str):
    """Set opt['a']['b']... for 'a:b=value'-style overrides."""
    keys, val = dotted.split("=", 1)
    node = opt
    parts = keys.split(":")
    for k in parts[:-1]:
        node = node.setdefault(k, {})
    node[parts[-1]] = parse_value(val)


def parse_options(root_path: str, is_train: bool = True, args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Override yaml options, e.g. train:total_iter=100")
    parser.add_argument("--launcher", choices=["none", "pytorch", "jax"], default="none",
                        help="'pytorch': one process per card under torchrun ('jax' is an "
                             "alias)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; cuda unless another is named (e.g. cpu)")
    parsed = parser.parse_args(args)
    if parsed.launcher == "jax":
        parsed.launcher = "pytorch"

    opt = ordered_yaml_load(parsed.opt)
    if is_kair_options(opt):
        opt = kair_to_opt(opt)
    if parsed.force_yml:
        for entry in parsed.force_yml:
            set_by_dotted(opt, entry.strip())
    n_dev = opt.get("num_devices", "auto")
    if parsed.launcher == "none" and n_dev not in (None, "auto") and int(n_dev) > 1:
        cli = "train" if is_train else "test"
        raise ValueError(f"num_devices {n_dev} with --launcher none: one process drives one "
                         f"card; run torchrun --nproc_per_node {n_dev} -m ssl_tpu_torch.{cli} "
                         f"-opt {parsed.opt} --launcher pytorch")
    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train

    if parsed.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]

    if opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)

    # dataset defaults
    for phase, dataset in (opt.get("datasets") or {}).items():
        phase_key = phase.split("_")[0]
        dataset["phase"] = phase_key
        if "scale" in opt:
            dataset["scale"] = opt["scale"]

    # paths
    for key, val in (opt.get("path") or {}).items():
        if val is not None and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = os.path.expanduser(val)
    opt.setdefault("path", {})
    if is_train:
        experiments_root = os.path.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = os.path.join(experiments_root, "models")
        opt["path"]["training_states"] = os.path.join(experiments_root, "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = os.path.join(experiments_root, "visualization")
        if parsed.debug:
            opt["val"] = opt.get("val") or {}
            opt["val"]["val_freq"] = 8
            opt["logger"] = opt.get("logger") or {}
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = os.path.join(results_root, "visualization")

    return opt, parsed


def dict2str(opt: dict, indent_level: int = 1) -> str:
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + f"{k}:[" + dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + f"{k}: {v}\n"
    return msg


def copy_opt_file(opt_file: str, experiments_root: str) -> None:
    """Archive the option file into the experiment dir with a command-line header."""
    import sys
    import time
    from shutil import copyfile
    os.makedirs(experiments_root, exist_ok=True)
    filename = os.path.join(experiments_root, os.path.basename(opt_file))
    copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {' '.join(sys.argv)}\n\n")
        f.seek(0)
        f.writelines(lines)
