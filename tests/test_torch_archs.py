"""The port's archs against ssl_tpu's on identical weights and inputs (fp32, CPU).

Weights are the JAX modules' own random init, carried into the port with
``ssl_tpu_torch.utils.weight_port.params_from_jax``.  Tolerances: the two
frameworks' convolutions sum in different orders, so outputs agree to float32
rounding amplified by depth: rtol 1e-4 with an atol of 1e-5 of the output's
largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_tpu.archs.discriminator_arch import VGGStyleDiscriminator as JDisc
from ssl_tpu.archs.rrdbnet_arch import RRDBNet as JRRDBNet
from ssl_tpu.archs.vgg_arch import VGGFeatureExtractor as JVGG
from ssl_tpu_torch.archs import RRDBNet, VGGFeatureExtractor, VGGStyleDiscriminator
from ssl_tpu_torch.archs.vgg_arch import load_torchvision_vgg19
from ssl_tpu_torch.utils.weight_port import params_from_jax


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(net, sd):
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("scan_blocks,scale", [(True, 4), (False, 4), (True, 2)])
def test_rrdbnet_forward_matches_jax(scan_blocks, scale):
    """Scale 2 pixel-unshuffles the input first (channel order (c, sh, sw))."""
    x = np.random.RandomState(0).rand(2, 12, 12, 3).astype(np.float32)
    jnet = JRRDBNet(num_feat=16, num_block=2, num_grow_ch=8, scan_blocks=scan_blocks, scale=scale)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jnet.apply(variables, jnp.asarray(x))
    net = RRDBNet(num_feat=16, num_block=2, num_grow_ch=8, scale=scale)
    _load(net, params_from_jax("RRDBNet", _np_tree(variables["params"])))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    _close(got.transpose(0, 2, 3, 1), ref)


def test_rrdbnet_carry_agrees_with_jax_exporter(tmp_path):
    """The carry's key mapping and values equal ssl_tpu's own torch exporter."""
    from ssl_tpu.utils.weight_port import export_rrdbnet_to_torch
    jnet = JRRDBNet(num_feat=8, num_block=2, num_grow_ch=4)
    params = _np_tree(jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 3)))["params"])
    export_rrdbnet_to_torch(params, str(tmp_path / "g.pth"))
    exported = torch.load(tmp_path / "g.pth")["params"]
    carried = params_from_jax("RRDBNet", params)
    assert sorted(exported) == sorted(carried)
    for k in exported:
        assert torch.equal(exported[k], carried[k]), k
    assert sorted(carried) == sorted(RRDBNet(num_feat=8, num_block=2, num_grow_ch=4).state_dict())


@pytest.mark.parametrize("input_size,num_feat", [(128, 8), (192, 4)])
def test_vgg_style_discriminator_train_mode_matches_jax(input_size, num_feat):
    """Train-mode forward and the batch-norm running stats after one call
    (flax momentum 0.9 with the biased batch variance); 192 adds a stage and
    ends at 3x3."""
    x = np.random.RandomState(3).rand(2, input_size, input_size, 3).astype(np.float32)
    jnet = JDisc(num_in_ch=3, num_feat=num_feat, input_size=input_size)
    variables = jnet.init(jax.random.PRNGKey(4), jnp.asarray(x))
    ref, new_vars = jnet.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    net = VGGStyleDiscriminator(num_in_ch=3, num_feat=num_feat, input_size=input_size)
    _load(net, params_from_jax("VGGStyleDiscriminator", _np_tree(variables["params"]),
                               _np_tree(variables["batch_stats"])))
    net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    _close(got, ref)
    stats = params_from_jax("VGGStyleDiscriminator", _np_tree(variables["params"]),
                            _np_tree(new_vars["batch_stats"]))
    sd = net.state_dict()
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    # eval mode normalizes with the running stats, as flax's use_running_average
    net.eval()
    ref_eval = jnet.apply(new_vars | {"params": variables["params"]}, jnp.asarray(x), False)
    with torch.no_grad():
        _close(net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy(), ref_eval)


def test_vgg_feature_extractor_taps_match_jax():
    layers = ("conv1_2", "relu2_1", "pool3", "conv5_4")
    x = np.random.RandomState(5).rand(1, 32, 32, 3).astype(np.float32)
    jnet = JVGG(layer_name_list=layers)
    variables = jnet.init(jax.random.PRNGKey(6), jnp.asarray(x))
    ref = jnet.apply(variables, jnp.asarray(x))
    net = VGGFeatureExtractor(layer_name_list=layers)
    _load(net, params_from_jax("VGGFeatureExtractor", _np_tree(variables["params"])))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert sorted(got) == sorted(layers)
    for name in layers:
        _close(got[name].numpy().transpose(0, 2, 3, 1), ref[name])


def test_vgg19_weight_file_loads_torchvision_layout(tmp_path):
    """A torchvision-format vgg19 state dict ('features.N.*') fills the taps'
    convolutions; ReLU and pool slots have no weights."""
    src = VGGFeatureExtractor(layer_name_list=("conv2_2",))
    src.reset_parameters(torch.Generator().manual_seed(3))
    feature_index = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7}
    sd = {}
    for name, i in feature_index.items():
        sd[f"features.{i}.weight"] = src.convs[name].weight.detach().clone()
        sd[f"features.{i}.bias"] = src.convs[name].bias.detach().clone()
    torch.save(sd, tmp_path / "vgg19.pth")
    dst = VGGFeatureExtractor(layer_name_list=("conv2_2",))
    load_torchvision_vgg19(dst, str(tmp_path / "vgg19.pth"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_reset_parameters_is_seeded():
    a, b = RRDBNet(num_feat=8, num_block=1, num_grow_ch=4), RRDBNet(num_feat=8, num_block=1,
                                                                    num_grow_ch=4)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
