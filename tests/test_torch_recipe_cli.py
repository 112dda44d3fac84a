"""The recipes through the port's CLIs on the CPU: the train CLI on SPSR-SSL
and RankSRGAN-SSL with a checkpoint and ``--auto_resume``, bit for bit
against a run without a break (with SPSR's gradient D and RankSRGAN's
Ranker in the training state); the test CLI on SPSR and SwinIR, whole and
tiled, against ssl_tpu's test CLI on the same JAX weights (``net_g_N.pkl``);
and each shipped train and test YAML built at its widths on the CPU.

Sizes: GT 64 cropped to 32, batch 2, 4 images; SPSRNet nf 4 / nb 20,
RankSRGANSRResNet nf 8 / nb 2, UNetDiscriminatorSN nf 4,
Discriminator_VGG_296 and Ranker_VGG12_296 nf 4, SwinIR embed 12, depths
[2, 2], window 4; SSL search 9 / window 5.

Tolerances: the test CLIs' PSNR within 1e-3 dB and SSIM within 1e-4, and
the saved images within one uint8 level (float32 convolutions in other
orders; an SR value near .5 may round either way)."""

import copy
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import ssl_tpu.test as jtest
import ssl_tpu_torch.test as ttest
import ssl_tpu_torch.train as ttrain
from ssl_tpu.models import build_model as jax_build_model
from ssl_tpu_torch.models import build_model
from torch_cli_cases import eval_opt, write_dataset, write_json
from torch_recipe_cases import G_OPTS, train_opt as recipe_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWINIR = dict(G_OPTS["SwinIR"], depths=[2, 2], num_heads=[2, 2])


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_init_once(monkeypatch):
    """The JAX package's ``init_params`` run once per net, input shape and
    seed: the JAX test CLI builds its model, and so initialises G, at each
    run, and the whole and tiled runs initialise the same G alike before
    loading ``net_g_N.pkl`` over it; flax's eager init of SPSRNet takes
    tens of seconds a call on this CPU."""
    from ssl_tpu.models.base_model import BaseModel
    init, done = BaseModel.init_params, {}

    def init_params(self, net, shape, rng_seed=0, extra_kwargs=None):
        key = (repr(net), tuple(shape), rng_seed, repr(extra_kwargs))
        if key not in done:
            done[key] = init(self, net, shape, rng_seed, extra_kwargs)
        return done[key]
    monkeypatch.setattr(BaseModel, "init_params", init_params)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("recipe_cli_data")), n_train=4, gt=64)


def _cli_opt(recipe, d, name, total_iter):
    opt = recipe_opt(recipe, total_iter=total_iter, warmup_iter=-1)
    opt.update(name=name, val={"val_freq": 100, "save_img": False},
               logger={"print_freq": 1, "save_checkpoint_freq": 2, "use_tb_logger": False})
    opt["datasets"] = {"train": {
        "name": "synth", "type": "PairedImageMaskDataset", "dataroot_gt": d["gt"],
        "dataroot_lq": d["lq"], "dataroot_gt_mask": d["mask"], "gt_size": 32,
        "use_hflip": True, "use_rot": True, "batch_size_per_gpu": 2, "num_worker_per_gpu": 0,
        "dataset_enlarge_ratio": 1}}
    return opt


def _tensors(state):
    out = {}
    nets = {"net_g": state.net_g, "net_g_ema": state.net_g_ema, "net_d": state.net_d,
            **state.nets, **{f"extra.{k}": v for k, v in (state.extra or {}).items()}}
    for name, net in nets.items():
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
    for name in ("opt_g", "opt_d"):
        for pid, st in getattr(state, name).state_dict()["state"].items():
            out.update({f"{name}.{pid}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("recipe", ["SPSRSSL", "RankSRGANPISSL"])
def test_train_cli_resume_is_bit_for_bit(recipe, folders, tmp_path):
    """4 iterations straight, and 2 then ``--auto_resume`` to 4 in another
    root: the same nets, optimizers and step bit for bit.  The saved state,
    reloaded into a fresh model, equals the run's."""
    straight_root, broken_root = str(tmp_path / "straight"), str(tmp_path / "broken")
    path = write_json(_cli_opt(recipe, folders, recipe, 4), str(tmp_path / "opt.json"))
    straight = ttrain.train_pipeline(straight_root, ["-opt", path, "--device", "cpu"])
    first = ttrain.train_pipeline(broken_root, ["-opt", path, "--device", "cpu", "--force_yml",
                                                "train:total_iter=2"])
    exp = os.path.join(broken_root, "experiments", recipe)
    models = set(os.listdir(os.path.join(exp, "models")))
    assert {"net_g_2.pth", "net_d_2.pth"} <= models
    assert ("net_d_grad_2.pth" in models) == (recipe == "SPSRSSL")

    opt = _cli_opt(recipe, folders, recipe, 4)
    fresh = build_model(dict(opt, is_train=True), device="cpu")
    reloaded, it = fresh.load_training_state(fresh.init_state(seed=7),
                                             os.path.join(exp, "training_states"))
    assert it == 2 and reloaded.step == 2
    want = _tensors(first)
    got = _tensors(reloaded)
    assert set(got) == set(want)
    assert any(k.startswith("net_d_grad." if recipe == "SPSRSSL" else "extra.net_r.")
               for k in got)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k

    resumed = ttrain.train_pipeline(broken_root, ["-opt", path, "--device", "cpu",
                                                  "--auto_resume"])
    assert resumed.step == straight.step == 4
    want = _tensors(straight)
    for k, v in _tensors(resumed).items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("g", ["SPSRNet", "SwinIR"])
def test_test_cli_matches_jax(g, folders, tmp_path, jax_init_once):
    """Both test CLIs on one JAX ``net_g_1.pkl``: SPSR takes its second
    output, SwinIR pads by a full window; whole and in tiles of 8 with a
    halo of 4."""
    root = str(tmp_path)
    net = dict(G_OPTS[g]) if g == "SPSRNet" else dict(SWINIR)
    model_type = "SPSRSSLModel" if g == "SPSRNet" else "SwinIRGANSSLModel"
    jmodel = jax_build_model(dict(eval_opt(folders, None, network_g=net, model_type=model_type),
                                  is_train=False))
    jstate = jmodel.init_state(lq_shape=(1, 16, 16, 3))
    jmodel.save_networks(jax.device_get(jstate), root, 1)
    weights = os.path.join(root, "net_g_1.pkl")
    for tiled in (False, True):
        results, images = {}, {}
        for name, cli, extra in (("jax", jtest, []), ("torch", ttest, ["--device", "cpu"])):
            run = f"{g}_{name}_{'tiled' if tiled else 'whole'}"
            opt = eval_opt(folders, weights, name=run, network_g=copy.deepcopy(net),
                           model_type=model_type, tile_process=tiled, tile_size=8, tile_pad=4)
            opt["path"]["param_key_g"] = "params"
            results[name] = cli.test_pipeline(root, ["-opt", write_json(
                opt, os.path.join(root, f"{run}.json"))] + extra)["synthval"]
            vis = os.path.join(root, "results", run, "visualization", "synthval")
            images[name] = [cv2.imread(os.path.join(vis, f"v{i}_{run}.png")).astype(int)
                            for i in range(2)]
        assert abs(results["torch"]["psnr"] - results["jax"]["psnr"]) < 1e-3
        assert abs(results["torch"]["ssim"] - results["jax"]["ssim"]) < 1e-4
        for a, b in zip(images["torch"], images["jax"]):
            assert a.shape == b.shape and np.abs(a - b).max() <= 1


@pytest.mark.parametrize("recipe", ["LDLSSL", "BebyGANSSL", "SPSRSSL", "RankSRGANPISSL",
                                    "SwinIRGANSSL", "ELANGANSSL"])
def test_shipped_recipe_options_build_and_need_a_card(recipe, tmp_path):
    """Each shipped train and test YAML parses through the port's options,
    builds its model at the shipped widths on the CPU (G, D, SPSR's gradient D,
    RankSRGAN's Ranker), whose G maps an 8^2 LQ to 32^2; without ``--device``
    and without a card both CLIs stop before reading any data."""
    from ssl_tpu_torch.utils.options import parse_options
    root = str(tmp_path)
    paths = {kind: os.path.join(REPO, "options", kind, recipe,
                                f"{kind}_{recipe}_bicubic_x4.yml") for kind in ("train", "test")}
    opt, _ = parse_options(root, True, ["-opt", paths["train"], "--device", "cpu"])
    model = build_model(opt, device="cpu")
    state = model.init_state(seed=0)
    assert type(state.net_g).__name__ == opt["network_g"]["type"]
    assert type(state.net_d).__name__ == opt["network_d"]["type"]
    assert set(state.nets) == ({"net_d_grad"} if recipe == "SPSRSSL" else set())
    assert set(state.extra or {}) == ({"net_r"} if recipe == "RankSRGANPISSL" else set())
    test_opt, _ = parse_options(root, False, ["-opt", paths["test"], "--device", "cpu",
                                              "--force_yml", "path:pretrain_network_g=~"])
    test_model = build_model(test_opt, device="cpu")
    net = test_model.init_state(seed=0).net_g
    assert type(net).__name__ == type(state.net_g).__name__
    with torch.no_grad():
        sr = test_model.infer(net.eval(), torch.rand(1, 3, 8, 8))
    assert tuple(sr.shape) == (1, 3, 32, 32) and bool(torch.isfinite(sr).all())
    if not torch.cuda.is_available():
        for cli, path in ((ttrain.train_pipeline, paths["train"]),
                          (ttest.test_pipeline, paths["test"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli(root, ["-opt", path])
