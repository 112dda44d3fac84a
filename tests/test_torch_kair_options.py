"""The port's KAIR option adapter against ssl_tpu's: equal option dicts on
the three shipped KAIR files and on every ``net_type``, ``netD`` and model
key, through ``parse_options`` (which no longer refuses a KAIR file), and
the shipped files' models built at their widths on the CPU.

Both adapters give SwinIR and ELAN the bare type: ``kair_to_opt`` copies
``netG``'s widths only for the RRDB and MSRResNet nets (``ROADMAP.md`` §3),
so the SwinIR recipe trains at SwinIR's defaults unless ``--force_yml`` sets
the file's widths."""

import copy
import os

import pytest
import torch

from ssl_tpu.utils import kair_options as jkair
from ssl_tpu.utils import options as jopt
from ssl_tpu_torch.models import build_model
from ssl_tpu_torch.utils import kair_options as tkair
from ssl_tpu_torch.utils import options as topt
from ssl_tpu_torch.utils.registry import build_network
from torch_kair_cases import KAIR_RECIPES, shipped, tiny_kair, write_json

FOLDERS = {k: f"/data/{k}" for k in ("gt", "mask", "vgt", "vlq")}


@pytest.mark.parametrize("recipe", KAIR_RECIPES)
def test_shipped_kair_files_parse_as_in_jax(recipe, tmp_path):
    path = shipped("train", recipe)
    got, _ = topt.parse_options(str(tmp_path), True, ["-opt", path, "--device", "cpu"])
    want, _ = jopt.parse_options(str(tmp_path), True, ["-opt", path])
    assert got == want
    assert got["model_type"] == "BSRGANSSLModel" and got["train"]["mask_stride"] == 3
    assert got["train"]["gan_opt"]["gan_type"] == "lsgan"
    assert got["network_d"] == {"type": "UNetDiscriminatorSN", "num_feat": 64}
    batch = {"BSRGANSSL": 48, "ELANGANSSL_BSRGAN": 64, "SwinIRGANSSL_BSRGAN": 16}[recipe]
    assert got["datasets"]["train"]["batch_size_per_gpu"] == batch
    # the adapter's fault, kept for parity: SwinIR and ELAN get their defaults
    if recipe != "BSRGANSSL":
        assert set(got["network_g"]) == {"type"}


NET_TYPES = sorted(set(jkair._NETG_MAP) | {"unknown_net"})
NETD_TYPES = sorted(set(jkair._NETD_MAP) | {"unknown_d"})


@pytest.mark.parametrize("net_type", NET_TYPES)
def test_every_net_type_adapts_as_in_jax(net_type):
    k = tiny_kair(FOLDERS, "n")
    k["netG"] = {"net_type": net_type, "nf": 8, "nb": 2, "gc": 4, "nc": 6}
    assert tkair.kair_to_opt(copy.deepcopy(k)) == jkair.kair_to_opt(copy.deepcopy(k))


@pytest.mark.parametrize("netd", NETD_TYPES)
@pytest.mark.parametrize("model", ["SSL", "gan", "plain"])
def test_every_discriminator_and_model_key_adapts_as_in_jax(netd, model):
    k = tiny_kair(FOLDERS, "d", G_lossfn_type="l2sum", gan_type="ragan")
    k.update(model=model, netD={"net_type": netd, "base_nc": 8, "n_layers": 2,
                                "norm_type": "batchspectral"})
    got = tkair.kair_to_opt(copy.deepcopy(k))
    assert got == jkair.kair_to_opt(copy.deepcopy(k))
    assert tkair.is_kair_options(k) and not tkair.is_kair_options(got)


def test_options_without_a_perceptual_term_adapt_as_in_jax():
    k = tiny_kair(FOLDERS, "p", perceptual=False, F_feature_layer=34, F_weights=1.0)
    got = tkair.kair_to_opt(copy.deepcopy(k))
    assert got == jkair.kair_to_opt(copy.deepcopy(k)) and "perceptual_opt" not in got["train"]


@pytest.mark.parametrize("recipe", KAIR_RECIPES)
def test_shipped_kair_models_build_at_full_width(recipe, tmp_path):
    """Each shipped KAIR file and test YAML builds its model on the CPU (the
    train file's G, D and EMA; the test YAML's G, at the file's widths), and
    without ``--device`` and a card both CLIs stop before reading any data.
    The SwinIR file with its own widths through ``--force_yml`` builds the G
    that its test YAML loads."""
    import ssl_tpu_torch.test as ttest
    import ssl_tpu_torch.train as ttrain
    root = str(tmp_path)
    train_args = ["-opt", shipped("train", recipe), "--device", "cpu"]
    if recipe == "SwinIRGANSSL_BSRGAN":
        train_args += ["--force_yml", "network_g:embed_dim=180",
                       "network_g:depths=[6, 6, 6, 6, 6, 6]",
                       "network_g:num_heads=[6, 6, 6, 6, 6, 6]"]
    opt, _ = topt.parse_options(root, True, train_args)
    opt["train"].pop("perceptual_opt")              # keep VGG19 out of this check
    model = build_model(opt, device="cpu")
    assert model.ema_decay == 0.999 and model.ssl_setting.mask_stride == 3
    with torch.device("meta"):                      # the widths, without the weights' memory
        g, d = model.build_g(), build_network(opt["network_d"])
    assert type(d).__name__ == "UNetDiscriminatorSN"
    test_opt, _ = topt.parse_options(root, False, ["-opt", shipped("test", recipe), "--device",
                                                   "cpu", "--force_yml",
                                                   "path:pretrain_network_g=~"])
    assert test_opt["model_type"] in ("BSGRANTestModel", "BSGRANTestSwinIRModel")
    with torch.device("meta"):
        net = build_model(test_opt, device="cpu").build_g()
    assert type(net).__name__ == type(g).__name__
    sizes = {k: v.shape for k, v in g.state_dict().items()}
    assert sizes == {k: v.shape for k, v in net.state_dict().items()}
    if not torch.cuda.is_available():
        for cli, path in ((ttrain.train_pipeline, shipped("train", recipe)),
                          (ttest.test_pipeline, shipped("test", recipe))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli(root, ["-opt", path])


def test_tiny_kair_file_parses_without_yaml(tmp_path, monkeypatch):
    """A .json KAIR file needs no ``yaml``."""
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = write_json(tiny_kair(FOLDERS, "noyaml"), os.path.join(tmp_path, "k.json"))
    opt, _ = topt.parse_options(str(tmp_path), True, ["-opt", path, "--device", "cpu"])
    assert opt["datasets"]["train"]["type"] == "DatasetBlindSRMask"
