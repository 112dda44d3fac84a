"""The port's bf16 knobs against ssl_tpu's, on the CPU: the SSG's
``q_store_dtype`` and ``stream_dtype`` on both dense routes, the route rule,
and ``compute_dtype`` on RRDBNet, UNetDiscriminatorSN and VGG19; and the
port's own bf16-against-float32 deviation under the contracts of
tests/test_ssg.py and tests/test_archs.py.

Inputs are made with numpy from a seed: the SSG's are the smooth images of
tests/test_ssg.py:186-275 (search 9, window 5, on 2x3x20x24), the nets'
carry JAX's seeded weights through ``utils/weight_port``.  bf16 rounds at
other points in the two frameworks (XLA keeps some intermediate values in
float32, and a q one float32 ulp apart may round to another bf16 value), so
the tolerances are bf16-level contracts (the JAX package's own for the
deviation tests), with the values measured on the CPU in the comments."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from ssl_tpu.ops import ssg as jssg
from ssl_tpu_torch.ops import ssg as tssg
from ssl_tpu_torch.ops.ssg_cuda import ssl_loss_sums
from ssl_tpu_torch.utils.weight_port import params_from_jax

# the modules (each package's ``losses`` exports the function of that name)
jloss = importlib.import_module("ssl_tpu.losses.ssl_loss")
tloss = importlib.import_module("ssl_tpu_torch.losses.ssl_loss")

KNOBS = {"store": ("bfloat16", "float32"), "stream": ("float32", "bfloat16"),
         "both": ("bfloat16", "bfloat16")}
# Loss rtol by knob: the store rounds q (2^-9 relative) after the row sums,
# the stream rounds D's differences before exp (the JAX contracts' ratio).
LOSS_RTOL = {"store": 1e-3, "stream": 5e-3, "both": 5e-3}
BUDGET = {"stored": str(2 ** 40), "batched": "0"}


def smooth_inputs(seed):
    """tests/test_ssg.py:197-204's smooth images: SR in [0, 1], GT a noisy copy."""
    rng = np.random.RandomState(seed)
    b, c, h, w = 2, 3, 20, 24
    base = gaussian_filter(rng.rand(b, c, h, w), sigma=(0, 0, 2, 2)).astype(np.float32)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    gt = np.clip(base + 0.05 * rng.randn(b, c, h, w), 0, 1).astype(np.float32)
    mask = (rng.rand(b, h, w) < 0.2).astype(np.float32)
    return base, gt, mask


def _setting(pkg, store, stream):
    opt = {"ssl_setting": {"kernel_size_search": 9, "kernel_size_window": 5, "sigma": 0.004,
                           "q_store_dtype": store, "stream_dtype": stream},
           "train": {"selfsim_opt": {"loss_weight": 1.0}, "selfsim1_opt": {"loss_weight": 1.0}}}
    return pkg.ssl_setting_from_opt(opt)


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("route", sorted(BUDGET))
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_ssg_bf16_matches_jax(knob, route, monkeypatch):
    """Both packages' ``ssl_loss`` with ``SSG_STORE_BYTES`` forcing the route:
    the losses within LOSS_RTOL (measured at most 1.6e-5 relative), d_sr of
    l_selfsim + 0.5 l_selfsim_kl with cosine > 0.9999 (measured >= 0.9999999)
    and within 1e-2 of its largest value (measured at most 1.4e-4: a q one
    float32 ulp apart can round to the next bf16 value); and the sums' counts
    equal.  On the batched route the store knob has no effect in either."""
    monkeypatch.setenv("SSG_STORE_BYTES", BUDGET[route])
    sr, gt, mask = smooth_inputs(3)
    store, stream = KNOBS[knob]
    js, ts = _setting(jloss, store, stream), _setting(tloss, store, stream)

    def loss_j(s):
        l1, kl = jloss.ssl_loss(s, jnp.asarray(gt.transpose(0, 2, 3, 1)), jnp.asarray(mask), js)
        return l1 + 0.5 * kl, (l1, kl)
    (_, ref), g_ref = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(sr.transpose(0, 2, 3, 1)))
    s = torch.from_numpy(sr).requires_grad_(True)
    got = tloss.ssl_loss(s, torch.from_numpy(gt), torch.from_numpy(mask), ts)
    (got[0] + 0.5 * got[1]).backward()
    for g, r in zip(got, ref):
        assert abs(float(g) - float(r)) <= LOSS_RTOL[knob] * abs(float(r)), (float(g), float(r))
    g_ref = np.asarray(g_ref).transpose(0, 3, 1, 2)
    g_got = s.grad.numpy()
    assert _cos(g_got, g_ref) > 0.9999
    assert np.abs(g_got - g_ref).max() <= 1e-2 * np.abs(g_ref).max()

    stored, cfg = tloss.dense_route(*mask.shape, ts.ssg)
    assert stored == (route == "stored")
    jfn = jssg.ssl_loss_dense_stored if stored else jssg.ssl_loss_dense_batched
    count_j = jfn(jnp.asarray(sr), jnp.asarray(gt), jnp.asarray(mask), js.ssg)[2]
    count_t = ssl_loss_sums(torch.from_numpy(sr), torch.from_numpy(gt), torch.from_numpy(mask),
                            cfg, stored)[2]
    assert float(count_t) == float(count_j)


@pytest.mark.parametrize("b,h,w,store,budget", [
    (24, 128, 128, "bfloat16", None),     # bench.py's step: 0.98 GB, stored
    (48, 256, 256, "bfloat16", None),     # BSRGAN-SSL's shape: 7.9 GB, batched
    (16, 128, 128, "float32", None),      # the shipped ESRGAN-SSL step: 1.31 GB, stored
    (24, 128, 128, "float32", None),      # 1.97 GB, stored
    (2, 512, 512, "float32", None),       # the diffusion mini-step: 2.6 GB, batched
    (24, 128, 128, "bfloat16", str(10 ** 9 - 1)),
    (2, 20, 24, "float32", "0")])
def test_dense_route_matches_jax(b, h, w, store, budget, monkeypatch):
    """The port's ``dense_route`` against the function JAX's ``ssl_loss``
    calls at that shape (its two dense routes replaced by spies)."""
    if budget is None:
        monkeypatch.delenv("SSG_STORE_BYTES", raising=False)
    else:
        monkeypatch.setenv("SSG_STORE_BYTES", budget)
    called = []

    def spy(name):
        def fn(sr, gt, mask, cfg):
            called.append(name)
            return jnp.zeros(()), jnp.zeros(()), jnp.ones(())
        return fn
    monkeypatch.setattr(jssg, "ssl_loss_dense_stored", spy("stored"))
    monkeypatch.setattr(jssg, "ssl_loss_dense_batched", spy("batched"))
    js = _setting(jloss, store, "bfloat16")
    img = jnp.zeros((b, h, w, 3))
    jloss.ssl_loss(img, img, jnp.zeros((b, h, w)), js)
    stored, cfg = tloss.dense_route(b, h, w, _setting(tloss, store, "bfloat16").ssg)
    assert called == ["stored" if stored else "batched"]
    assert cfg.q_store_dtype == (store if stored else "float32")
    assert cfg.stream_dtype == "bfloat16"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_as_torch(family, grads, net):
    """JAX's parameter gradients in the torch net's layout (the carry is
    linear), in the order of ``net.named_parameters``."""
    carried = params_from_jax(family, _np_tree(grads))
    return np.concatenate([carried[k].numpy().ravel() for k, _ in net.named_parameters()])


def _torch_grads(net):
    return np.concatenate([p.grad.numpy().ravel() for _, p in net.named_parameters()])


def test_rrdbnet_bf16_matches_jax():
    """RRDBNet nf 16 / nb 3 / gc 8 in bf16 against the JAX module's bf16 on
    its seeded weights: float32 parameters and image, the image within 3e-2
    of its scale of JAX's (measured 7.6e-3) and the parameter gradient of
    mean |G(x) - 1| with cosine > 0.95 (measured 0.9676).  JAX's dense
    blocks regroup their convs by source (``split_convs``) and round the
    partial sums in bf16, so the two differ by bf16 rounding."""
    from ssl_tpu.archs.rrdbnet_arch import RRDBNet as JRRDBNet
    from ssl_tpu_torch.archs import RRDBNet
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    jnet = JRRDBNet(num_feat=16, num_block=3, num_grow_ch=8, compute_dtype="bfloat16")
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    g_ref = jax.grad(lambda p: jnp.mean(jnp.abs(jnet.apply({"params": p}, jnp.asarray(x)) - 1)))(
        variables["params"])
    net = RRDBNet(num_feat=16, num_block=3, num_grow_ch=8, compute_dtype="bfloat16")
    net.load_state_dict(params_from_jax("RRDBNet", _np_tree(variables["params"])))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    out = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert out.dtype == torch.float32
    assert np.abs(out.detach().numpy() - ref).max() / np.abs(ref).max() < 3e-2
    torch.mean(torch.abs(out - 1)).backward()
    assert _cos(_torch_grads(net), _grads_as_torch("RRDBNet", g_ref, net)) > 0.95


def test_unet_discriminator_bf16_matches_jax():
    """UNetDiscriminatorSN nf 16 in bf16, train mode, against JAX's bf16 on
    its seeded weights and spectral-norm state: float32 parameters, u, sigma
    and logits; the logits within 3e-2 of their scale (measured 6.6e-3),
    the parameter gradient of mean (D(x) - 1)^2 with cosine > 0.99 (measured
    0.9944), and the updated u within 1e-5 (measured 2.1e-7: both power
    iterations run in float32 on the float32 weights)."""
    from ssl_tpu.archs.discriminator_arch import UNetDiscriminatorSN as JUNetD
    from ssl_tpu_torch.archs import UNetDiscriminatorSN
    x = np.random.RandomState(1).rand(2, 32, 32, 3).astype(np.float32)
    jnet = JUNetD(num_feat=16, compute_dtype="bfloat16")
    variables = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params, stats = variables["params"], variables["batch_stats"]

    def loss_j(p):
        out, new = jnet.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                              mutable=["batch_stats"])
        return jnp.mean((out - 1.0) ** 2), (out, new["batch_stats"])
    (_, (ref, new_stats)), g_ref = jax.value_and_grad(loss_j, has_aux=True)(params)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    net = UNetDiscriminatorSN(num_feat=16, compute_dtype="bfloat16")
    net.load_state_dict(params_from_jax("UNetDiscriminatorSN", _np_tree(params), _np_tree(stats)))
    out = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert out.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in net.state_dict().values())
    assert np.abs(out.detach().numpy() - ref).max() / np.abs(ref).max() < 3e-2
    torch.mean((out - 1.0) ** 2).backward()
    assert _cos(_torch_grads(net), _grads_as_torch("UNetDiscriminatorSN", g_ref, net)) > 0.99
    want = params_from_jax("UNetDiscriminatorSN", _np_tree(params), _np_tree(new_stats))
    for k, v in net.state_dict().items():
        if k.endswith(".u"):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_vgg_bf16_matches_jax():
    """VGG19 to conv3_4 in bf16 against JAX's bf16 on its seeded weights:
    the float32 tap within 3e-2 of its scale (measured 4.1e-3) and the
    input gradient of mean |f(x) - f(0)| with cosine > 0.98 (measured
    0.9996); and ``PerceptualLoss`` takes the option key."""
    from ssl_tpu.archs.vgg_arch import VGGFeatureExtractor as JVGG
    from ssl_tpu_torch.archs import VGGFeatureExtractor
    from ssl_tpu_torch.utils.registry import build_loss
    taps = ("conv3_4",)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    jnet = JVGG(layer_name_list=taps, compute_dtype="bfloat16")
    variables = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x))[taps[0]]).transpose(0, 3, 1, 2)
    f0 = jax.lax.stop_gradient(jnet.apply(variables, jnp.zeros_like(jnp.asarray(x)))[taps[0]])
    g_ref = np.asarray(jax.grad(lambda xx: jnp.mean(jnp.abs(
        jnet.apply(variables, xx)[taps[0]] - f0)))(jnp.asarray(x))).transpose(0, 3, 1, 2)
    net = VGGFeatureExtractor(layer_name_list=taps, compute_dtype="bfloat16")
    net.load_state_dict(params_from_jax("VGGFeatureExtractor", _np_tree(variables["params"])),
                        strict=False)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = net(xt)[taps[0]]
    assert out.dtype == torch.float32
    assert np.abs(out.detach().numpy() - ref).max() / np.abs(ref).max() < 3e-2
    with torch.no_grad():
        t0 = net(torch.zeros_like(xt))[taps[0]]
    torch.mean(torch.abs(out - t0)).backward()
    assert _cos(xt.grad.numpy(), g_ref) > 0.98
    loss = build_loss({"type": "PerceptualLoss", "layer_weights": {"conv3_4": 1.0},
                       "compute_dtype": "bfloat16"})
    assert loss.vgg.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("knob,loss_rtol,cos_min,max_frac", [
    # tests/test_ssg.py:186; measured l1 / kl rel 4.0e-4 / 5.8e-4, cos 0.99948 / 0.999996
    ("store", 2e-3, 0.999, 0.1),
    # tests/test_ssg.py:229; measured l1 / kl rel 1.0e-3 / 2.1e-3, cos 0.9978 / 0.9992
    ("stream", 2e-2, 0.99, 0.15)])
def test_ssg_bf16_deviation(knob, loss_rtol, cos_min, max_frac):
    """The port's stored route in bf16 against its own float32, under the
    JAX package's contracts: counts equal, l1 and kl within ``loss_rtol``,
    each of their gradients with cosine > ``cos_min`` and within
    ``max_frac`` of the float32 gradient's largest value."""
    sr, gt, mask = smooth_inputs(3 if knob == "store" else 5)
    store, stream = KNOBS[knob]
    cfg32 = tssg.SSGConfig(search=9, window=5)
    cfg16 = tssg.SSGConfig(search=9, window=5, q_store_dtype=store, stream_dtype=stream)
    gt_t, mask_t = torch.from_numpy(gt), torch.from_numpy(mask)

    def run(cfg, idx):
        s = torch.from_numpy(sr).requires_grad_(True)
        out = ssl_loss_sums(s, gt_t, mask_t, cfg, stored=True)
        out[idx].backward()
        return out, s.grad.numpy()
    for idx in (0, 1):
        o32, g32 = run(cfg32, idx)
        o16, g16 = run(cfg16, idx)
        assert float(o32[2]) == float(o16[2])
        assert abs(float(o16[idx]) - float(o32[idx])) < loss_rtol * abs(float(o32[idx]))
        assert _cos(g32, g16) > cos_min
        assert np.abs(g32 - g16).max() < max_frac * np.abs(g32).max() + 1e-8


@pytest.mark.parametrize("arch", ["RRDBNet", "UNetDiscriminatorSN", "VGGFeatureExtractor"])
def test_net_bf16_deviation(arch):
    """The port's nets in bf16 against themselves in float32 on the same
    seeded weights, under tests/test_archs.py's contracts (83, 118, 154):
    identical float32 state dicts, the float32 output within 3e-2 of its
    scale (measured 7.6e-3, 7.4e-3, 7.8e-3), and the gradient's cosine above
    0.95 (G, parameters), 0.99 (D, parameters) and 0.98 (VGG, input)
    (measured 1.0000, 1.0000, 0.9938)."""
    from ssl_tpu_torch.utils.registry import build_network
    opt = {"RRDBNet": {"type": "RRDBNet", "num_feat": 16, "num_block": 3, "num_grow_ch": 8},
           "UNetDiscriminatorSN": {"type": "UNetDiscriminatorSN", "num_feat": 16},
           "VGGFeatureExtractor": {"type": "VGGFeatureExtractor",
                                   "layer_name_list": ["conv3_4"]}}[arch]
    size, cos_min = {"RRDBNet": (16, 0.95), "UNetDiscriminatorSN": (32, 0.99),
                     "VGGFeatureExtractor": (32, 0.98)}[arch]
    nets = [build_network(dict(opt, compute_dtype=dt)) for dt in ("float32", "bfloat16")]
    nets[0].reset_parameters(torch.Generator().manual_seed(4))
    nets[1].load_state_dict(nets[0].state_dict())
    assert all(t.dtype == torch.float32 for t in nets[1].state_dict().values())
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 3, size, size).astype(np.float32))
    outs, grads = [], []
    for net in nets:
        xx = x.clone().requires_grad_(True)
        out = net(xx)
        out = out["conv3_4"] if isinstance(out, dict) else out
        assert out.dtype == torch.float32
        loss = {"RRDBNet": lambda o: torch.mean(torch.abs(o - 1)),
                "UNetDiscriminatorSN": lambda o: torch.mean((o - 1) ** 2),
                "VGGFeatureExtractor": lambda o: torch.mean(torch.abs(o))}[arch](out)
        loss.backward()
        outs.append(out.detach().numpy())
        grads.append(xx.grad.numpy() if arch == "VGGFeatureExtractor" else _torch_grads(net))
    assert np.abs(outs[0] - outs[1]).max() / np.abs(outs[0]).max() < 3e-2
    assert _cos(*grads) > cos_min
