"""``parallel/spatial.py::spatial_infer`` on gloo worlds of 2 and 3 ranks
against ``ssl_tpu.parallel.spatial.spatial_infer`` on JAX meshes of the same
size (``tests/conftest.py``'s virtual CPU devices) and against the
whole-image pass; the small-image case runs whole; ``spatial_infer: true``
and ``--spatial`` route through it.

The net is MSRResNet nf 8 / nb 1 (tests/test_spatial_infer.py's) with the
JAX weights carried.  Tolerance rtol 1e-5, atol 1e-5 (the JAX test's): the
same convolutions in two frameworks.  Heights: 256 at 2 ranks (bands of
128), 250 at 3 (not a multiple: reflect-padded to 252; the whole-image
comparison leaves out the output rows that see the pad, as the JAX test
does), and 40 with halo 32 at 2 ranks (too small: whole)."""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases

NET = {"type": "MSRResNet", "num_feat": 8, "num_block": 1, "upscale": 4}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in this process too: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    import jax
    import jax.numpy as jnp
    from ssl_tpu.archs import build_network
    from ssl_tpu_torch.utils.weight_port import params_from_jax
    jnet = build_network(dict(NET))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    sd = params_from_jax("MSRResNet", jax.tree_util.tree_map(np.asarray, params))
    return (lambda p, x: jnet.apply({"params": p}, x)), params, sd


def _img(seed, h):
    return np.random.RandomState(seed).rand(1, h, 16, 3).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _jax_spatial(apply_fn, params, img, n, halo):
    import jax
    import jax.numpy as jnp
    from ssl_tpu.parallel.spatial import create_spatial_mesh, spatial_infer
    out = spatial_infer(apply_fn, params, jnp.asarray(img), scale=4,
                        mesh=create_spatial_mesh(jax.devices()[:n]), halo=halo)
    return np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("world", [2, 3])
def test_spatial_infer_matches_jax_and_the_whole_image(net, world):
    apply_fn, params, sd = net
    h = 256 if world == 2 else 250
    imgs = [(_img(world, h), 16)] + ([(_img(7, 40), 32)] if world == 2 else [])

    def jax_refs():
        return [_jax_spatial(apply_fn, params, img, world, halo) for img, halo in imgs]

    ranks, refs = cases.run_world(cases.spatial_cases, world, NET, sd,
                                  [(_nchw(img), halo) for img, halo in imgs],
                                  after_start=jax_refs)
    for got in ranks[1:]:                        # every rank holds the whole output
        for a, b in zip(got, ranks[0]):
            assert torch.equal(a, b)
    for (img, _), got, ref in zip(imgs, ranks[0], refs):
        assert got.shape == ref.shape == (1, 3, img.shape[1] * 4, 64)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
        whole = np.asarray(apply_fn(params, img)).transpose(0, 3, 1, 2)
        keep = got.shape[2] if img.shape[1] % world == 0 else (img.shape[1] - 16) * 4
        np.testing.assert_allclose(got.numpy()[:, :, :keep], whole[:, :, :keep], **TOL)


def test_spatial_infer_option_routes_through_it(net, tmp_path, monkeypatch):
    """At one rank ``spatial_infer: true`` (SRModel.test) and ``--spatial``
    (the inference CLI) give the whole-image pass through spatial_infer."""
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import TrainState
    from ssl_tpu_torch.parallel import spatial
    from ssl_tpu_torch.scripts.inference import inference_ssl_sr
    from ssl_tpu_torch.utils.img_util import imread, imwrite
    _, _, sd = net
    calls = []
    real = spatial.spatial_infer
    monkeypatch.setattr("ssl_tpu_torch.models.sr_model.spatial_infer",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    opt = {"name": "sp", "model_type": "SRModel", "scale": 4, "is_train": False,
           "manual_seed": 0, "spatial_infer": True, "spatial_halo": 16,
           "network_g": dict(NET), "path": {}}
    model = build_model(opt, device="cpu")
    g = model.build_g()
    g.load_state_dict(sd)
    lq = _nchw(_img(3, 64))
    out = model.test(TrainState(step=0, net_g=g.eval()), lq)
    with torch.no_grad():
        assert torch.equal(out, g(lq))
    assert calls == [{"halo": 16}]
    (tmp_path / "lq").mkdir()
    imwrite((_img(4, 24)[0] * 255).astype(np.uint8), str(tmp_path / "lq" / "a.png"))
    torch.save({"params": sd}, tmp_path / "g.pth")
    written = inference_ssl_sr.main(
        ["--input", str(tmp_path / "lq"), "--output", str(tmp_path / "o"), "--model_path",
         str(tmp_path / "g.pth"), "--arch", "MSRResNet", "--num_feat", "8", "--num_block", "1",
         "--net_opt", '{"upscale": 4}', "--spatial", "--spatial_halo", "8", "--device", "cpu"])
    assert len(written) == 1 and imread(written[0]).shape[:2] == (96, 64)
    assert calls[-1] == {"halo": 8}
