"""The reference's OmegaConf-schema configs and SD / ldm / StableSR checkpoints
in the port against ssl_tpu, on the CPU.

* ``diffusion/ref_config.py``: ``translate_reference_config`` gives JAX's
  dict on a CFW config and a stage-1 config that the tests write (the
  layouts of the reference's configs/autoencoder/autoencoder_kl_64x64x4_resi.yaml
  and configs/SSL/base.yaml, at tiny widths); the stage-1 one builds through
  ``diffusion/main.py`` what JAX's ``build_from_config`` builds, and the CFW
  one trains a step through the CFW CLI; each entry point refuses the other
  kind, as JAX's does.
* Checkpoint import (``utils/weight_port.py::load_reference_state``,
  ``StableSRSSL(vae_ckpt=, unet_ckpt=)``): a reference-layout state dict
  loaded over seeded weights by the port and through ssl_tpu's
  ``convert_ldm_vae`` / ``convert_sd_unet`` / ``convert_sd_structcond`` and
  ``merge_into_tree`` gives the same weights, bit for bit.  Weights are drawn
  with numpy from seeds at the flax shapes
  (tests/torch_diffusion_cases.py::seeded_params)."""

import copy
import dataclasses
import inspect
import json

import jax
import numpy as np
import pytest
import torch

from ssl_tpu.diffusion.main import build_from_config as jax_build
from ssl_tpu.diffusion.ref_config import translate_reference_config as jax_translate
from ssl_tpu.diffusion.unet import EncoderUNetModelWT as JEnc
from ssl_tpu.diffusion.unet import UNetModelDualcondV2 as JUNet
from ssl_tpu.diffusion.vae import AutoencoderKL as JVAE
from ssl_tpu.diffusion.vae import AutoencoderKLResi as JResi
from ssl_tpu.utils import weight_port as jwp
from ssl_tpu_torch.diffusion import cfw_train
from ssl_tpu_torch.diffusion.ddpm_ssl import StableSRSSL
from ssl_tpu_torch.diffusion.main import build_from_config
from ssl_tpu_torch.diffusion.ref_config import is_reference_schema, translate_reference_config
from ssl_tpu_torch.diffusion.unet import EncoderUNetModelWT, UNetModelDualcondV2
from ssl_tpu_torch.diffusion.vae import AutoencoderKL, AutoencoderKLResi
from ssl_tpu_torch.utils.img_util import imwrite
from ssl_tpu_torch.utils.weight_port import load_reference_state, params_from_jax
from torch_diffusion_cases import CFG, STRUCT, UNET, seeded_params

B = 2
RESI = dict(embed_dim=4, ch=8, ch_mult=(1, 2, 2, 2), num_res_blocks=1, num_fuse_block=1)

# configs/autoencoder/autoencoder_kl_64x64x4_resi.yaml's layout
CFW_REF = {
    "model": {
        "base_learning_rate": 5.0e-5,
        "target": "ldm.models.autoencoder.AutoencoderKLResi",
        "params": {
            "embed_dim": 4, "monitor": "val/rec_loss", "ckpt_path": "/no/such/v2-1.ckpt",
            "fusion_w": 1.0, "freeze_dec": True, "synthesis_data": False,
            "lossconfig": {"target": "ldm.modules.losses.LPIPSWithDiscriminator",
                           "params": {"disc_start": 501, "kl_weight": 0, "disc_weight": 0.025,
                                      "disc_factor": 1.0}},
            "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 512, "in_channels": 3,
                         "out_ch": 3, "ch": 8, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 1,
                         "num_fuse_block": 1, "attn_resolutions": [], "dropout": 0.0},
            "image_key": "gt"}},
    "data": {"target": "main.DataModuleFromConfig",
             "params": {"batch_size": 2, "num_workers": 0, "wrap": True,
                        "train": {"target": "basicsr.data.single_image_dataset.SingleImageNPDataset",
                                  "params": {"gt_path": ["/no/such/dump"], "crop_size": 16,
                                             "io_backend": {"type": "disk"}}}}},
    "lightning": {"trainer": {"max_steps": 3, "accumulate_grad_batches": 1}},
}

# configs/SSL/base.yaml's layout, at the tiny widths of tests/torch_diffusion_cases.py
STAGE1_REF = {
    "model": {
        "base_learning_rate": 5.0e-5,
        "target": "ldm.models.diffusion.ddpmssl.LatentDiffusionSRTextWTSSL",
        "params": {
            "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 20,
            "scale_factor": 0.18215, "parameterization": "eps",
            "sslopt": {"mask_stride": 3, "kernel_size": 9, "scaling_factor": 0.1,
                       "kernel_size_center": 5, "softmax_sr": True},
            "unet_config": {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModelDualcondV2",
                            "params": {"model_channels": 32, "num_res_blocks": 1,
                                       "channel_mult": [1, 2], "attention_resolutions": [1, 2],
                                       "num_heads": 4, "context_dim": 32, "semb_channels": 32,
                                       "use_linear_in_transformer": True}},
            "first_stage_config": {"target": "ldm.models.autoencoder.AutoencoderKL",
                                   "params": {"embed_dim": 4, "ckpt_path": "/no/such/vae.ckpt",
                                              "ddconfig": {"ch": 16, "ch_mult": [1, 2],
                                                           "num_res_blocks": 1}}},
            "structcond_stage_config": {
                "target": "ldm.modules.diffusionmodules.openaimodel.EncoderUNetModelWT",
                "params": {"model_channels": 32, "channel_mult": [1, 2], "out_channels": 32,
                           "num_res_blocks": 1, "num_heads": 4, "attention_resolutions": [1, 2]}}}},
    "ISSL_loss": {"selfsim_opt": {"loss_weight": 0.5}, "selfsim1_opt": {"loss_weight": 0.5}},
    "degradation": {"noise_range": [1, 15], "queue_size": 0},
    "data": {"target": "main.DataModuleFromConfig",
             "params": {"batch_size": 2, "num_workers": 0,
                        "train": {"target": "basicsr.data.realesrgan_dataset."
                                            "TwoStageDegradation_Img_Mask_Dataset",
                                  "params": {"gt_size": 32, "queue_size": 0}}}},
    "lightning": {"trainer": {"max_steps": 10, "accumulate_grad_batches": 2},
                  "modelcheckpoint": {"params": {"every_n_train_steps": 5}}},
}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("which", ["cfw", "stage1"])
def test_translate_matches_jax(which):
    """The port's copy of ref_config translates as JAX's does, key for key
    (placeholder checkpoint paths dropped, tuples where JAX makes them)."""
    cfg = CFW_REF if which == "cfw" else STAGE1_REF
    assert is_reference_schema(cfg)
    got, want = translate_reference_config(copy.deepcopy(cfg)), jax_translate(copy.deepcopy(cfg))
    assert got == want and got["kind"] == which.replace("stage1", "ssl")
    if which == "cfw":
        # the translation's fault (ROADMAP.md, section 3): no network_d and no
        # perceptual term, so a reference CFW config trains on the pixel L1 alone
        assert "network_d" not in got and "perceptual_opt" not in got["train"]
        assert got["path"]["pretrain_vae"] is None


def test_reference_stage1_builds_what_jax_builds():
    """build_from_config on the stage-1 reference dict: the translated model
    (schedule, scale factor, UNet, struct-cond encoder and VAE widths) is
    JAX's."""
    got, ref = build_from_config(copy.deepcopy(STAGE1_REF)), jax_build(copy.deepcopy(STAGE1_REF))
    assert got.cfg._asdict() == ref.cfg._asdict()
    assert (got.lr, got.accumulate) == (5e-5, 2)          # base_learning_rate, the trainer's
    assert got.vae_ckpt is None and got.unet_ckpt is None
    # each net is the port's net of the JAX module's own fields
    for net, port_cls, jnet in ((got.unet, UNetModelDualcondV2, ref.unet),
                                (got.structcond, EncoderUNetModelWT, ref.structcond),
                                (got.vae, AutoencoderKL, ref.vae)):
        keys = inspect.signature(port_cls).parameters
        fields = {f.name: getattr(jnet, f.name) for f in dataclasses.fields(jnet)
                  if f.name in keys}
        with torch.device("meta"):
            twin = port_cls(**fields)
        assert [(k, v.shape) for k, v in net.state_dict().items()] == \
            [(k, v.shape) for k, v in twin.state_dict().items()]


def test_each_entry_point_refuses_the_other_kind(tmp_path):
    """diffusion/main refuses a CFW config with SystemExit, and the CFW CLI
    a stage-1 one with an AssertionError, as in JAX."""
    for build in (build_from_config, jax_build):
        with pytest.raises(SystemExit, match="cfw_train"):
            build(copy.deepcopy(CFW_REF))
    path = str(tmp_path / "stage1.json")
    json.dump(STAGE1_REF, open(path, "w"))
    with pytest.raises(AssertionError, match="CFW"):
        cfw_train.load_cfw_config(path)


def test_reference_cfw_config_trains_through_the_cli(tmp_path):
    """The CFW reference dict drives the CFW CLI (2 steps at its tiny widths
    on a dump without latents: the encoder-mean route); it trains on the
    pixel L1 alone, as JAX's translation gives it."""
    rng = np.random.RandomState(0)
    for sub in ("gts", "inputs", "samples"):
        (tmp_path / "dump" / sub).mkdir(parents=True)
        for i in range(2):
            imwrite((rng.rand(24, 24, 3) * 255).astype(np.uint8),
                    str(tmp_path / "dump" / sub / f"{i}.png"))
    base = str(tmp_path / "resi.json")
    json.dump(CFW_REF, open(base, "w"))
    seen = []
    args = type("A", (), dict(base=base, logdir=str(tmp_path / "logs"),
                              data_root=str(tmp_path / "dump"), resume=None, device="cpu",
                              overrides=["train.max_steps=2", "train.log_every=1"]))
    state = cfw_train.train(args, on_step=lambda step, logs, st: seen.append(sorted(logs)))
    assert state.step == 2 and seen == [["l_pix", "l_total"]] * 2
    assert (tmp_path / "logs" / "cfw_2.pkl").is_file()


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("layout", ["full_cfw", "bare_cfw", "full_plain_sd"])
def test_reference_vae_file_loads_as_jax_merges_it(tmp_path, layout):
    """A reference-layout VAE state dict (ldm's names; under
    first_stage_model. with the other nets' and the loss's keys beside it, or
    bare) loaded over seeded weights by the port and through
    convert_ldm_vae + merge_into_tree: the same weights bit for bit.  A plain
    SD VAE (no fusion layers) leaves the fusion layers at their init in
    both."""
    img = np.zeros((B, 32, 32, 3), np.float32)
    init = seeded_params(JResi(**RESI), img, seed=7)
    file_net = AutoencoderKLResi(**RESI)
    file_net.load_state_dict(params_from_jax(
        "AutoencoderKLResi", jax.tree_util.tree_map(lambda a: a * 1.5 + 0.25, init)))
    sd = {k: v.clone() for k, v in file_net.state_dict().items()}
    if layout == "full_plain_sd":
        sd = {k: v for k, v in sd.items() if "fusion_layer" not in k}
    if layout.startswith("full"):
        sd = {**{f"first_stage_model.{k}": v for k, v in sd.items()},
              "model.diffusion_model.out.2.weight": torch.ones(4, 8, 3, 3),
              "loss.discriminator.main.0.weight": torch.ones(8, 3, 4, 4)}
    path = str(tmp_path / "vae.ckpt")
    torch.save({"state_dict": sd, "global_step": 3}, path)

    merged = jwp.merge_into_tree(init, jwp._as_jnp(jwp.convert_ldm_vae(
        jwp.load_torch_state_dict(path, "state_dict"))))
    net = AutoencoderKLResi(**RESI)
    init_sd = params_from_jax("AutoencoderKLResi", init)
    net.load_state_dict(init_sd)
    dropped = load_reference_state(net, torch.load(path, weights_only=True)["state_dict"], "vae")
    assert dropped == []
    want = params_from_jax("AutoencoderKLResi", jax.tree_util.tree_map(np.asarray, merged))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    fusion = [k for k in got if "fusion_layer" in k]
    kept = [k for k in fusion if torch.equal(got[k], init_sd[k])]
    assert len(kept) == (len(fusion) if layout == "full_plain_sd" else 0)


def test_cfw_file_into_a_plain_vae_drops_the_fusion_layers():
    """The port drops (and returns) keys the module lacks, where the JAX
    merge adds them to the params tree unread: a CFW state dict loaded as
    a plain AutoencoderKL."""
    img = np.zeros((B, 32, 32, 3), np.float32)
    tree = seeded_params(JResi(**RESI), img, seed=3)
    sd = params_from_jax("AutoencoderKLResi", tree)
    plain = {k: v for k, v in RESI.items() if k != "num_fuse_block"}
    net = AutoencoderKL(**plain)
    dropped = load_reference_state(net, sd, "vae")
    assert dropped and all("fusion_layer" in k for k in dropped)
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())
    merged = jwp.merge_into_tree(seeded_params(JVAE(**plain), img, seed=4),
                                 jwp.convert_ldm_vae(sd))
    assert "fusion_layer_1" in merged["decoder"]         # JAX keeps them in the tree


@pytest.fixture(scope="module")
def stage1_file(tmp_path_factory):
    """A full StableSR-layout checkpoint of the tiny stage-1 nets (UNet,
    struct-cond encoder, VAE, and a text-encoder key beside them) from
    seeded weights, and the trees the file is merged over (the file's
    values, moved)."""
    rng = np.random.RandomState(3)
    z = rng.randn(B, 16, 16, 4).astype(np.float32)
    t = np.asarray([3, 17], np.int32)
    ctx = rng.randn(B, CFG["context_len"], CFG["context_dim"]).astype(np.float32)
    img = np.zeros((B, 32, 32, 3), np.float32)
    vae_kw = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, embed_dim=4)
    sp = seeded_params(JEnc(**STRUCT), z, t, seed=2)
    feats = jax.eval_shape(JEnc(**STRUCT).apply, {"params": sp}, z, t)
    f = {"structcond": sp, "unet": seeded_params(JUNet(**UNET), z, t, ctx, feats, seed=12),
         "vae": seeded_params(JVAE(**vae_kw), img, seed=22)}
    init = jax.tree_util.tree_map(lambda a: a * 0.5 - 0.125, f)
    sd = {**{f"model.diffusion_model.{k}": v for k, v in
             params_from_jax("UNetModelDualcondV2", f["unet"]).items()},
          **{f"structcond_stage_model.{k}": v for k, v in
             params_from_jax("EncoderUNetModelWT", f["structcond"]).items()},
          **{f"first_stage_model.{k}": v for k, v in
             params_from_jax("AutoencoderKL", f["vae"]).items()},
          "cond_stage_model.model.ln_final.weight": torch.ones(32)}
    path = str(tmp_path_factory.mktemp("stage1") / "stablesr.ckpt")
    torch.save({"state_dict": sd}, path)
    return {"path": path, "init": init, "sd": sd, "vae_kw": vae_kw}


def _port_nets(init, vae_kw):
    nets = {"unet": UNetModelDualcondV2(**UNET), "structcond": EncoderUNetModelWT(**STRUCT),
            "vae": AutoencoderKL(**vae_kw)}
    for name, family in (("unet", "UNetModelDualcondV2"), ("structcond", "EncoderUNetModelWT"),
                         ("vae", "AutoencoderKL")):
        nets[name].load_state_dict(params_from_jax(family, init[name]))
    return nets


def test_vae_and_unet_ckpt_import_as_jax_merges_them(stage1_file):
    """StableSRSSL(vae_ckpt=, unet_ckpt=) on a full checkpoint: the UNet,
    the struct-cond encoder and the VAE equal what ssl_tpu's
    convert_sd_unet / convert_sd_structcond / convert_ldm_vae merged over the
    init give, bit for bit (the port's init carried from the same tree);
    the EMA starts as the imported weights."""
    path, init = stage1_file["path"], stage1_file["init"]
    model = StableSRSSL(unet=UNetModelDualcondV2(**UNET), structcond=EncoderUNetModelWT(**STRUCT),
                        vae=AutoencoderKL(**stage1_file["vae_kw"]), vae_ckpt=path,
                        unet_ckpt=path,
                        cfg=StableSRSSL().cfg._replace(context_dim=CFG["context_dim"],
                                                       context_len=CFG["context_len"]))
    state = model.init_state(seed=0, device="cpu")
    jsd = jwp.load_torch_state_dict(path, "state_dict")
    merged = {"unet": jwp.merge_into_tree(init["unet"], jwp.convert_sd_unet(jsd)),
              "structcond": jwp.merge_into_tree(init["structcond"],
                                                jwp.convert_sd_structcond(jsd)),
              "vae": jwp.merge_into_tree(init["vae"], jwp.convert_ldm_vae(jsd))}
    nets = {"unet": (state.params["unet"], state.ema_params["unet"], "UNetModelDualcondV2"),
            "structcond": (state.params["structcond"], state.ema_params["structcond"],
                           "EncoderUNetModelWT"),
            "vae": (state.frozen["vae"], None, "AutoencoderKL")}
    for name, (net, ema, family) in nets.items():
        want = params_from_jax(family, jax.tree_util.tree_map(np.asarray, merged[name]))
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
            if ema is not None:
                assert torch.equal(ema.state_dict()[k], v)
    # over the port's own init the file's keys land the same way
    direct = _port_nets(init, stage1_file["vae_kw"])
    for name in ("unet", "structcond", "vae"):
        load_reference_state(direct[name], stage1_file["sd"], name)
        want = state.frozen["vae"] if name == "vae" else state.params[name]
        assert all(torch.equal(a, b) for a, b in
                   zip(direct[name].state_dict().values(), want.state_dict().values()))


def test_bare_unet_file_leaves_the_struct_encoder(stage1_file, tmp_path):
    """A bare UNet state dict (no model.diffusion_model. prefix) imports the
    UNet only: the struct-cond encoder is imported only where the file has
    structcond_stage_model. keys, as in JAX."""
    prefix = "model.diffusion_model."
    sd = {k[len(prefix):]: v for k, v in stage1_file["sd"].items() if k.startswith(prefix)}
    nets = _port_nets(stage1_file["init"], stage1_file["vae_kw"])
    before = {k: v.clone() for k, v in nets["structcond"].state_dict().items()}
    load_reference_state(nets["unet"], sd, "unet")
    want = params_from_jax("UNetModelDualcondV2", jax.tree_util.tree_map(
        np.asarray, jwp.merge_into_tree(stage1_file["init"]["unet"], jwp.convert_sd_unet(sd))))
    assert all(torch.equal(v, want[k]) for k, v in nets["unet"].state_dict().items())
    assert jwp.convert_sd_structcond(sd) and not any(k.startswith("structcond_stage_model.")
                                                     for k in sd)
    assert all(torch.equal(v, before[k]) for k, v in nets["structcond"].state_dict().items())


def test_sd2_projection_shapes(stage1_file):
    """SD 2.x keeps proj_in / proj_out as 2-d Linear weights, which both
    packages take (the cases above); the 1x1-conv form (4-d, SD 1.x's) is
    refused by both with a shape mismatch."""
    sd = dict(stage1_file["sd"])
    key = next(k for k in sd if k.startswith("model.diffusion_model.") and
               k.endswith("proj_in.weight"))
    assert sd[key].ndim == 2
    sd[key] = sd[key][:, :, None, None]
    with pytest.raises(ValueError, match="shape"):
        jwp.merge_into_tree(stage1_file["init"]["unet"], jwp.convert_sd_unet(sd))
    net = _port_nets(stage1_file["init"], stage1_file["vae_kw"])["unet"]
    with pytest.raises(ValueError, match="shape"):
        load_reference_state(net, sd, "unet")


def test_missing_checkpoint_file_raises(tmp_path):
    """A missing vae_ckpt / unet_ckpt raises FileNotFoundError at
    init_state before any weight is made (torch.load's, as in JAX's
    load_torch_state_dict); the CFW trainer's pretrain_vae likewise."""
    for key in ("vae_ckpt", "unet_ckpt"):
        model = StableSRSSL(**{key: str(tmp_path / "missing.ckpt")})
        with pytest.raises(FileNotFoundError):
            model.init_state(device="cpu")
    tm = cfw_train.CFWTrainModel({"vae": RESI, "path": {"pretrain_vae": str(tmp_path / "x.ckpt")}})
    with pytest.raises(FileNotFoundError):
        tm.init_state(device="cpu")
