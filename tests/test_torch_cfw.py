"""StableSR's stage 2 in the port against ssl_tpu's, on the CPU: the CFW
autoencoder (``AutoencoderKLResi``) in float32 and bf16, its weight carry
both ways, two CFW training steps with a discriminator, the datasets, and
the stage-2 CLIs end to end (dump -> cfw_train -> resume -> test_cli
--vqgan_ckpt).  Reference-layout checkpoints and configs:
tests/test_torch_ref_config.py.

The geometry is tiny: ch 8, ch_mult (1, 2, 2, 2), 1 res block, 1 fuse block,
32^2 images (64^2 GT for the dump), weights drawn with numpy from seeds at the
flax shapes (tests/torch_diffusion_cases.py::seeded_params).

Tolerances.  The autoencoder in float32: rtol 1e-5 with an atol of 1e-6 of
the reference's largest value (float32 sums in other orders).  bf16: the
diffusion nets' bf16 contract, 3e-2 of the reference's largest value against
JAX's bf16 and against the port's own float32
(tests/test_torch_diffusion_bf16.py).  The
train steps: the logs rtol 1e-4, the weights within lr/5 with rounding-noise
gradients allowed up to 2.2 lr on at most 5% of the elements
(tests/torch_diffusion_train_cases.py::check_weights, lr 5e-5, with the
floor per tensor: ``check_trained``); the EMA within 0.0021 of those bounds
(after two steps it has moved 0.001 + 0.000999 of the way) and four float32
roundings of its values.  Weight
carries: bit for bit."""

import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs.discriminator_arch import NLayerDiscriminator as JNLayer
from ssl_tpu.data.paired_image_dataset import SingleImageNPDataset as JNPDataset
from ssl_tpu.diffusion import cfw_train as jcfw
from ssl_tpu.diffusion.vae import AutoencoderKLResi as JResi
from ssl_tpu.models.base_model import TrainState
from ssl_tpu_torch.data.paired_image_dataset import SingleImageNPDataset
from ssl_tpu_torch.diffusion import cfw_train, test_cli
from ssl_tpu_torch.diffusion.main import build_from_config
from ssl_tpu_torch.diffusion.vae import AutoencoderKLResi
from ssl_tpu_torch.scripts import gt_input_output
from ssl_tpu_torch.utils.img_util import imwrite
from ssl_tpu_torch.utils.weight_port import params_from_jax, params_to_jax
from torch_diffusion_cases import nchw, seeded_params
from torch_diffusion_train_cases import GRAD_FLOOR, NOISE_SHARE, check_logs

RESI = dict(embed_dim=4, ch=8, ch_mult=(1, 2, 2, 2), num_res_blocks=1, num_fuse_block=1)
D = dict(ndf=8, n_layers=2)
B, SIZE = 2, 32
LR = 5e-5
BOUND = 3e-2
BF16 = "bfloat16"


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (the suite runs several test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, rtol=1e-5):
    """rtol with an atol of 1e-6 of the reference's largest value; got NCHW
    torch or NHWC numpy, ref NHWC."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
        if got.ndim == 4:
            got = got.transpose(0, 2, 3, 1)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 * np.abs(ref).max())


def scaled_err(got, ref) -> float:
    got = got.detach().float().numpy().transpose(0, 2, 3, 1)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def port_resi(tree, **kw) -> AutoencoderKLResi:
    net = AutoencoderKLResi(**RESI, **kw)
    net.load_state_dict(params_from_jax("AutoencoderKLResi", tree))     # strict
    return net.eval()


@pytest.fixture(scope="module")
def resi():
    """Seeded CFW weights, an image in [-1, 1] and a latent; JAX's encode
    and decode in float32 and bf16."""
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    lq = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.randn(B, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    tree = seeded_params(JResi(**RESI), img, seed=7)
    ref = {}
    for dtype in (None, BF16):
        mean, logvar, feas, decoded = jax_resi(tree, img, lq, z, dtype)
        ref[dtype] = {"mean": mean, "logvar": logvar, "feas": feas, "decoded": decoded}
    return {"tree": tree, "img": img, "lq": lq, "z": z, "ref": ref}


def jax_resi(tree, img, lq, z, dtype=None):
    """JAX's encode of ``img`` and decode of ``z`` with ``lq``'s features,
    in one jitted function (eager flax is slower than its compile here),
    compiled once per type."""
    return _jax_resi_fn(dtype)(tree, img, lq, z)


@functools.lru_cache(maxsize=None)
def _jax_resi_fn(dtype):
    j = JResi(**RESI, use_flash_attention=True, compute_dtype=dtype)

    def run(p, x, y, zz):
        mean, logvar, feas = j.apply({"params": p}, x, method=j.encode)
        return mean, logvar, feas, j.apply({"params": p}, zz,
                                           j.apply({"params": p}, y, method=j.encode)[2],
                                           method=j.decode)
    return jax.jit(run)


def port_outputs(r, dtype):
    net = port_resi(r["tree"], use_flash_attention=True, compute_dtype=dtype)
    with torch.no_grad():
        mean, logvar, feas = net.encode(nchw(r["img"]))
        lq_feas = net.encode(nchw(r["lq"]))[2]
        decoded = net.decode(nchw(r["z"]), lq_feas)
    return {"mean": mean, "logvar": logvar, "feas": feas, "decoded": decoded}


def test_cfw_autoencoder_matches_jax(resi):
    """encode's mean, logvar and the two level features (16^2 x 16, 8^2 x
    16), and decode of a latent with the LQ's features, in float32."""
    got, ref = port_outputs(resi, None), resi["ref"][None]
    assert len(got["feas"]) == len(ref["feas"]) == 2
    for k in ("mean", "logvar", "decoded"):
        close(got[k], ref[k])
    for g, r in zip(got["feas"], ref["feas"]):
        close(g, r)


def test_cfw_autoencoder_bf16_contract(resi):
    """compute_dtype bfloat16: float32 outputs within 3e-2 of scale of
    JAX's bf16 and of the port's float32; the features come back float32."""
    got, ref, f32 = port_outputs(resi, BF16), resi["ref"][BF16], port_outputs(resi, None)
    for k in ("mean", "logvar", "decoded"):
        assert got[k].dtype == torch.float32
        assert scaled_err(got[k], ref[k]) < BOUND, k
        assert float((got[k] - f32[k]).abs().max() / f32[k].abs().max()) < BOUND, k
    for g, r in zip(got["feas"], ref["feas"]):
        assert g.dtype == torch.float32 and scaled_err(g, r) < BOUND


def test_cfw_weight_carry_both_ways(resi):
    """params_to_jax(params_from_jax(tree)) is the tree, key for key and bit
    for bit; the fusion layers carry ldm's names (a fuse block's skip is
    conv_out, its trunk encode_enc_2.{k}.rdb{r}.conv{c})."""
    sd = params_from_jax("AutoencoderKLResi", resi["tree"])
    assert "decoder.fusion_layer_1.encode_enc_1.conv_out.weight" in sd
    assert "decoder.fusion_layer_2.encode_enc_2.0.rdb3.conv5.bias" in sd
    back = params_to_jax("AutoencoderKLResi", port_resi(resi["tree"]))
    flat = jax.tree_util.tree_flatten_with_path
    got, want = flat(back)[0], flat(jax.tree_util.tree_map(np.asarray, resi["tree"]))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(g, w)


# ---------------------------------------------------------------- train step
def cfw_opt(pretrain=None):
    return {"vae": dict(RESI, use_flash_attention=True),
            "network_d": {"type": "NLayerDiscriminator", **D},
            "train": {"optim_g": {"type": "Adam", "lr": LR}, "optim_d": {"type": "Adam", "lr": LR},
                      "pixel_weight": 1.0, "ema_decay": 0.999},
            "path": {"pretrain_vae": pretrain}}


@pytest.fixture(scope="module")
def steps(resi):
    """Two CFW steps with the D on one batch (latents present) in both
    packages from the same weights; the port's gradients as Adam took them."""
    rng = np.random.RandomState(5)
    batch = {k: rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
             for k in ("gt", "lq", "sr")}
    batch["latent"] = (0.18215 * rng.randn(B, SIZE // 8, SIZE // 8, 4)).astype(np.float32)
    x = np.zeros((B, SIZE, SIZE, 3), np.float32)
    pd = seeded_params(JNLayer(**D), x, seed=9)
    shapes = jax.eval_shape(JNLayer(**D).init, jax.random.PRNGKey(0), x)["batch_stats"]
    stats = {k: {"mean": np.zeros(v["mean"].shape, np.float32),
                 "var": np.ones(v["var"].shape, np.float32)} for k, v in shapes.items()}

    jm = jcfw.CFWTrainModel(cfw_opt())
    tree = jax.tree_util.tree_map(jnp.asarray, resi["tree"])
    trainable, frozen = jcfw._split_params(tree)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                        params_g=trainable, opt_state_g=jm.tx_g.init(trainable),
                        ema_params_g=jax.tree_util.tree_map(jnp.copy, trainable),
                        extra={"frozen": frozen}, params_d=jax.tree_util.tree_map(jnp.asarray, pd),
                        stats_d=jax.tree_util.tree_map(jnp.asarray, stats),
                        opt_state_d=jm.tx_d.init(jax.tree_util.tree_map(jnp.asarray, pd)))

    tm = cfw_train.CFWTrainModel(cfw_opt())
    state = tm.init_state(device="cpu")
    for net in (state.net, state.ema):
        net.load_state_dict(params_from_jax("AutoencoderKLResi", resi["tree"]))
    state.net_d.load_state_dict(params_from_jax("NLayerDiscriminator", pd, stats), strict=False)
    names = [n for n, p in state.net.named_parameters() if p.requires_grad]
    grads = []
    state.opt_g.register_step_pre_hook(lambda *a: grads.append(
        {n: p.grad.clone() for n, p in zip(names, cfw_train.trainable(state.net))}))
    tb = {k: nchw(v) for k, v in batch.items()}
    step = jm.make_train_step()
    logs = []
    for _ in range(2):
        jstate, jlogs = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tlogs = tm.train_step(state, tb)
        logs.append((tlogs, jlogs))
    return {"jm": jm, "jstate": jstate, "tm": tm, "state": state, "logs": logs,
            "grads": grads, "batch": batch, "names": names, "tree": resi["tree"]}


def check_trained(got: dict, ref: dict, grads: dict, scale: float = 1.0, ulps: int = 0):
    """tests/torch_diffusion_train_cases.py::check_weights with the
    rounding-noise floor taken per tensor: 1e-5 of the tensor's own largest
    gradient, or of the net's where the whole tensor is below that (a bias
    before a GroupNorm of one channel a group has a gradient of 0 but for
    rounding).  The fuse blocks' RRDB trunk takes gradients ~1e-4 of the
    net's largest (its dense blocks and the RRDB scale by 0.2), which the
    net-wide floor would count as noise; per tensor only a subset of the
    net-wide floor's elements get the noise bound.  ``ulps`` adds that many
    float32 roundings of each value (the EMA's own updates round)."""
    top = max(float(g.abs().max()) for g in grads.values())
    noisy = total = 0
    for name, r in ref.items():
        g = grads[name].abs()
        own = float(g.max())
        floor = g < GRAD_FLOOR * (own if own >= GRAD_FLOOR * top else top)
        atol = scale * (LR / 5 + 2 * LR * floor.to(r.dtype)) + ulps * 2.0 ** -24 * r.abs()
        diff = (got[name] - r).abs()
        bad = diff > atol
        assert not bool(bad.any()), (name, float(diff.max()), float(g[bad].max()))
        noisy += int(floor.sum())
        total += r.numel()
    assert noisy <= NOISE_SHARE * total, (noisy, total)


def _flat_g(tree) -> dict:
    return params_from_jax("AutoencoderKLResi", jax.tree_util.tree_map(np.asarray, tree))


def test_cfw_steps_match_jax(steps):
    """Two steps: the logs (l_pix, l_g_gan, l_total, l_d) each step; the
    trained weights and their EMA, the frozen encoder unchanged, and the D's
    weights and running statistics after two."""
    for tlogs, jlogs in steps["logs"]:
        assert sorted(tlogs) == ["l_d", "l_g_gan", "l_pix", "l_total"]
        check_logs(tlogs, jlogs)
    jstate, state = steps["jstate"], steps["state"]
    assert state.step == int(jstate.step) == 2
    frozen = jstate.extra["frozen"]
    want = _flat_g({**frozen, **jstate.params_g})
    want_ema = _flat_g({**frozen, **jstate.ema_params_g})
    got = dict(state.net.named_parameters())
    # a gradient counts as rounding noise when it was so in either step
    grads = {n: torch.minimum(steps["grads"][0][n].abs(), steps["grads"][1][n].abs())
             for n in steps["names"]}
    check_trained({n: got[n].detach() for n in grads}, {n: want[n] for n in grads}, grads)
    ema = dict(state.ema.named_parameters())
    check_trained({n: ema[n].detach() for n in grads}, {n: want_ema[n] for n in grads}, grads,
                  scale=0.0021, ulps=4)
    for n, p in got.items():
        if n.split(".", 1)[0] in cfw_train.FROZEN:
            assert torch.equal(p, want[n]) and not p.requires_grad, n
    start = params_from_jax("AutoencoderKLResi", steps["tree"])
    moved = sum(int(((got[n] - start[n]).abs() > LR).sum()) for n in grads)
    assert moved > 0.9 * sum(got[n].numel() for n in grads)      # two steps of ~lr each
    want_d = params_from_jax("NLayerDiscriminator",
                             jax.tree_util.tree_map(np.asarray, jstate.params_d),
                             jax.tree_util.tree_map(np.asarray, jstate.stats_d))
    for k, v in want_d.items():
        np.testing.assert_allclose(state.net_d.state_dict()[k].numpy(), v.numpy(),
                                   atol=LR / 5 if "running" not in k else 1e-5, err_msg=k)


def test_cfw_decode_falls_back_to_the_encoder_mean(resi):
    """Without a latent the decode takes the frozen encoder's mean of the
    stage-1 image, as the JAX ``_decode_cfw`` does."""
    jm = jcfw.CFWTrainModel(cfw_opt())
    trainable, frozen = jcfw._split_params(resi["tree"])
    ref = jax.jit(jm._decode_cfw)(trainable, frozen, resi["img"], resi["lq"])
    tm = cfw_train.CFWTrainModel(cfw_opt())
    with torch.no_grad():
        got = tm.decode_cfw(port_resi(resi["tree"], use_flash_attention=True),
                            nchw(resi["img"]), nchw(resi["lq"]))
    close(got, ref)


def test_cfw_pickles_serve_in_either_package(steps, tmp_path):
    """save_cfw_params of either package: the same {'params': tree} layout,
    and a pickle written by one decodes in the other's AutoencoderKLResi to
    the same image."""
    jpath, tpath = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jcfw.save_cfw_params(steps["jstate"], jpath)
    cfw_train.save_cfw_params(steps["state"], tpath)
    trees = [pickle.load(open(p, "rb"))["params"] for p in (jpath, tpath)]
    shapes = [jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), t) for t in trees]
    assert shapes[0] == shapes[1]
    b = steps["batch"]
    cfg = {"model": {"first_stage": dict(RESI)}}
    for tree, path in zip(trees, (jpath, tpath)):
        ref = jax_resi(tree, b["lq"], b["lq"], b["latent"] / 0.18215)[3]
        net = test_cli.load_cfw(cfg, path, "cpu")
        with torch.no_grad():
            got = net.decode(nchw(b["latent"]) / 0.18215, net.encode(nchw(b["lq"]))[2])
        close(got, ref)


# ------------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A {gts,inputs,latents,samples} root: 3 items of 48^2 images, inputs
    at 24^2 (upscaled by the readers' matlab resize), HWC latents."""
    root = tmp_path_factory.mktemp("dump")
    rng = np.random.RandomState(4)
    for sub in ("gts", "inputs", "latents", "samples"):
        os.makedirs(root / sub)
    for i in range(3):
        for sub, size in (("gts", 48), ("inputs", 24), ("samples", 48)):
            imwrite((rng.rand(size, size, 3) * 255).astype(np.uint8), str(root / sub / f"{i}.png"))
        np.save(root / "latents" / f"{i}.npy", rng.randn(6, 6, 4).astype(np.float32))
    return root


def test_cfw_triplet_dataset_matches_jax(dump):
    """Items (crop 16, 8-aligned, the latent cropped at /8) and the loop's
    indices from the two RandomState(0) streams equal JAX's."""
    jds = jcfw.CFWTripletDataset.from_root(str(dump), crop_size=16)
    tds = cfw_train.CFWTripletDataset.from_root(str(dump), crop_size=16)
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(3):
        idx = jrng.randint(0, len(jds), size=2)
        assert np.array_equal(idx, trng.randint(0, len(tds), size=2))
        for i in idx:
            j, t = jds[int(i)], tds[int(i)]
            assert sorted(j) == sorted(t) == ["gt", "latent", "lq", "sr"]
            for k in j:
                assert t[k].dtype == np.float32 and np.array_equal(t[k], j[k]), k
            assert t["latent"].shape == (2, 2, 4)


@pytest.mark.parametrize("layout", ["hwc", "reference_1chw"])
def test_single_image_np_dataset_matches_jax(dump, tmp_path, layout):
    """SingleImageNPDataset (registered): the items of both packages on both
    latent layouts, the port's CHW where JAX's are HWC."""
    root = dump
    if layout == "reference_1chw":
        import shutil
        root = tmp_path / "ref"
        shutil.copytree(dump, root)
        for f in os.listdir(root / "latents"):
            a = np.load(root / "latents" / f)
            np.save(root / "latents" / f, a.transpose(2, 0, 1)[None])
    opt = {"gt_path": str(root), "image_type": "png"}
    jds, tds = JNPDataset(opt), build_np_dataset(opt)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        j, t = jds[i], tds[i]
        for k in ("lq", "gt", "sample", "latent"):
            assert np.array_equal(t[k].numpy().transpose(1, 2, 0), j[k]), k
        assert t["latent_path"] == j["latent_path"]


def build_np_dataset(opt):
    from ssl_tpu_torch.data import build_dataset
    ds = build_dataset({**opt, "type": "SingleImageNPDataset", "phase": "train"})
    assert isinstance(ds, SingleImageNPDataset)
    return ds


# ------------------------------------------------------------------ end to end
def test_stage2_clis_end_to_end(tmp_path):
    """The dump of 2 GT images of 64^2 with the port's scripts, the CFW CLI
    for 2 steps on it (with a D, a reference-layout pretrain_vae written from
    the stage-1 VAE, and a native config), --resume to 3 (the state
    reloaded: step 3 equals a straight run's), and test_cli --vqgan_ckpt:
    the image differs from the plain decode's, and the port's cfw_3.pkl
    decoded by JAX's AutoencoderKLResi gives the port's decode."""
    stage1 = {"model": {"timesteps": 20, "context_dim": 32, "context_len": 4,
                        "unet": {"model_channels": 32, "num_res_blocks": 1, "channel_mult": [1, 2],
                                 "attention_resolutions": [2], "num_head_channels": 8},
                        "first_stage": {"embed_dim": 4, "ch": 8, "ch_mult": [1, 2, 2, 2],
                                        "num_res_blocks": 1}},
              "sslopt": {"kernel_size_search": 9, "kernel_size_window": 5}}
    cfg_path = str(tmp_path / "stage1.json")
    json.dump(stage1, open(cfg_path, "w"))
    model = build_from_config(stage1)
    s1 = model.init_state(seed=0, device="cpu")
    ckpt = str(tmp_path / "ckpt.pkl")
    pickle.dump(params_to_jax("StableSRSSL", s1.params), open(ckpt, "wb"))
    vae_file = str(tmp_path / "sd_vae.ckpt")
    torch.save({"state_dict": {f"first_stage_model.{k}": v
                               for k, v in s1.frozen["vae"].state_dict().items()}}, vae_file)
    gt_dir = tmp_path / "gt"
    os.makedirs(gt_dir)
    rng = np.random.RandomState(1)
    for i in range(2):
        imwrite((rng.rand(70, 66, 3) * 255).astype(np.uint8), str(gt_dir / f"im{i}.png"))
    out = str(tmp_path / "dump")
    names = gt_input_output.main(["--config", cfg_path, "--ckpt", ckpt, "--gt_dir", str(gt_dir),
                                  "--outdir", out, "--ddpm_steps", "2", "--seed", "0",
                                  "--device", "cpu"])
    assert names == ["im0.png", "im1.png"]
    for sub in ("gts", "inputs", "latents", "samples"):
        assert len(os.listdir(os.path.join(out, sub))) == 2
    assert np.load(os.path.join(out, "latents", "im0.npy")).shape == (8, 8, 4)

    cfw_cfg = {**cfw_opt(vae_file), "data": {"batch_size": 2, "crop_size": 32,
                                             "train": {"gt_path": [out]}},
               "train": {**cfw_opt()["train"], "max_steps": 2, "log_every": 1, "save_every": 2}}
    base = str(tmp_path / "cfw.json")
    json.dump(cfw_cfg, open(base, "w"))
    logdir = str(tmp_path / "logs")
    args = ["--base", base, "--logdir", logdir, "--device", "cpu"]
    first = cfw_train.main(args)
    enc = first.net.encoder.state_dict()
    vae_enc = s1.frozen["vae"].encoder.state_dict()
    assert all(torch.equal(enc[k], vae_enc[k]) for k in enc)       # imported, then frozen
    # cfw_state_2.pkl reloaded into a fresh state bit for bit
    tm = cfw_train.CFWTrainModel(cfw_train.load_cfw_config(base))
    fresh = tm.init_state(seed=1, device="cpu")
    cfw_train.load_cfw_state(os.path.join(logdir, "cfw_state_2.pkl"), fresh)
    assert fresh.step == first.step == 2
    for a, b in ((first.net, fresh.net), (first.ema, fresh.ema), (first.net_d, fresh.net_d)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for a, b in ((first.opt_g, fresh.opt_g), (first.opt_d, fresh.opt_d)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sorted(sa) == sorted(sb)
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    resumed = cfw_train.main(args + ["--resume", os.path.join(logdir, "cfw_state_2.pkl"),
                                     "train.max_steps=3"])
    assert resumed.step == 3 and os.path.isfile(os.path.join(logdir, "cfw_3.pkl"))
    assert any(not torch.equal(a, b) for a, b in
               zip(resumed.net.decoder.state_dict().values(),
                   fresh.net.decoder.state_dict().values()))

    lq_dir = tmp_path / "lq"
    os.makedirs(lq_dir)
    imwrite((rng.rand(16, 16, 3) * 255).astype(np.uint8), str(lq_dir / "a.png"))
    common = ["--config", cfg_path, "--ckpt", ckpt, "--init-img", str(lq_dir), "--ddpm_steps", "2",
              "--device", "cpu", "--colorfix_type", "nofix"]
    cfw_pkl = os.path.join(logdir, "cfw_3.pkl")
    import cv2
    test_cli.main(common + ["--outdir", str(tmp_path / "plain")])
    test_cli.main(common + ["--outdir", str(tmp_path / "cfw"), "--vqgan_ckpt", cfw_pkl])
    plain = cv2.imread(str(tmp_path / "plain" / "a.png"))
    cfw_img = cv2.imread(str(tmp_path / "cfw" / "a.png"))
    assert plain.shape == cfw_img.shape == (64, 64, 3) and not np.array_equal(plain, cfw_img)

    tree = pickle.load(open(cfw_pkl, "rb"))["params"]
    rng = np.random.RandomState(2)
    lq = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.randn(B, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    ref = jax_resi(tree, lq, lq, z)[3]
    net = test_cli.load_cfw(stage1, cfw_pkl, "cpu")
    with torch.no_grad():
        got = net.decode(nchw(z), net.encode(nchw(lq))[2])
    close(got, ref)


def test_missing_vqgan_ckpt_raises(tmp_path):
    """A missing --vqgan_ckpt raises FileNotFoundError before any output."""
    with pytest.raises(FileNotFoundError):
        test_cli.main(["--config", "x.json", "--ckpt", "x.pkl", "--init-img", str(tmp_path),
                       "--outdir", str(tmp_path / "out"), "--vqgan_ckpt",
                       str(tmp_path / "missing.pkl"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")


def test_parallel_data_raises(tmp_path):
    """parallel.data > 1 on the CFW CLI is not ported yet."""
    base = str(tmp_path / "cfw.json")
    json.dump({**cfw_opt(), "parallel": {"data": 2}}, open(base, "w"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfw_train.main(["--base", base, "--logdir", str(tmp_path), "--device", "cpu"])

