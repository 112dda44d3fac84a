"""The port's package boundary: it imports neither JAX nor ssl_tpu, and its
entry points target CUDA unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "ssl_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ssl_tpu")
SHIPPED_YML = os.path.join(REPO, "options", "train", "ESRGANSSL",
                           "train_ESRGANSSL_bicubic_x4.yml")


def _modules():
    out = []
    for root, _, files in os.walk(PACKAGE):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                out.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(out)


def _imported_roots(path):
    """Root package of every import statement in a file (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_every_module_leaves_jax_and_ssl_tpu_out():
    """In a fresh interpreter (this test process has JAX loaded by conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_imports_without_cv2_yaml_lmdb_tensorboardx():
    """The card's machine has none of them: each is imported only inside the
    function that needs it."""
    code = (
        "import importlib, sys\n"
        "for m in ('cv2', 'yaml', 'lmdb', 'tensorboardX'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stdout + proc.stderr
    assert "ssl_tpu_torch.train" in _modules() and "ssl_tpu_torch.utils.png" in _modules()
    assert {"ssl_tpu_torch.scripts.inference.common",
            "ssl_tpu_torch.scripts.inference.inference_ssl_sr",
            "ssl_tpu_torch.scripts.generate_bicubic_lr"} <= set(_modules())


@pytest.mark.parametrize("path", [
    os.path.join(REPO, f) for f in ("chip_smoke.py", "scripts/profile_torch_train_step.py",
                                    "scripts/profile_torch_serve_step.py",
                                    "scripts/profile_torch_diffusion_train_step.py",
                                    "scripts/profile_torch_attention_bwd.py",
                                    "scripts/profile_torch_k1.py",
                                    "tests/test_torch_cuda.py", "tests/torch_ssg_cases.py",
                                    "tests/torch_cli_cases.py",
                                    "tests/torch_attention_cases.py")] + [
    os.path.join(r, f) for r, _, fs in sorted(os.walk(PACKAGE)) for f in sorted(fs)
    if f.endswith(".py")])
def test_no_source_imports_jax_or_ssl_tpu(path):
    """Static scan: the root of each import must not be a forbidden package
    (``ssl_tpu_torch`` is allowed: the match is on the whole root name).
    The scripts and card-only tests run on a machine without JAX, too."""
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), (path, sorted(roots & set(FORBIDDEN)))


def test_build_model_targets_cuda_by_default(monkeypatch):
    from ssl_tpu_torch.models import build_model
    from ssl_tpu_torch.models.base_model import resolve_device
    with open(SHIPPED_YML) as f:
        opt = yaml.safe_load(f)
    if not torch.cuda.is_available():
        # no silent CPU run: the default device fails loudly here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(opt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_model_on_cpu_when_asked():
    from ssl_tpu_torch.models import ESRGANSSLModel, build_model
    with open(SHIPPED_YML) as f:
        opt = yaml.safe_load(f)
    opt["train"].pop("perceptual_opt")                   # keep VGG19 out of this check
    model = build_model(opt, device="cpu")
    assert isinstance(model, ESRGANSSLModel) and model.device.type == "cpu"
    assert model.ssl_setting.ssg.search == 25 and model.use_ssl


def test_unported_options_raise():
    from ssl_tpu_torch.models.base_model import build_optimizer
    from ssl_tpu_torch.utils.registry import build_network
    from ssl_tpu.models.base_model import build_optimizer as jax_build_optimizer
    for build in (lambda: build_optimizer({"type": "Lion"}, [torch.zeros(1, requires_grad=True)],
                                          lambda s: 0.1),
                  lambda: jax_build_optimizer({"type": "Lion"}, lambda s: 0.1)):
        with pytest.raises(NotImplementedError):    # refused by both packages
            build()
    with pytest.raises(NotImplementedError):       # a diffusion compute_dtype but bf16 / fp32
        from ssl_tpu_torch.diffusion.vae import AutoencoderKL
        AutoencoderKL(compute_dtype="float16")
    with pytest.raises(KeyError):                  # a video net: queue 1 item 12
        build_network({"type": "BasicVSR"})


def test_schedules_match_jax():
    from ssl_tpu.models import lr_scheduler as jsched
    from ssl_tpu_torch.models import lr_scheduler as tsched
    opts = [{"scheduler": {"type": "MultiStepLR", "milestones": [3, 6], "gamma": 0.5}},
            {"scheduler": {"type": "MultiStepRestartLR", "milestones": [2, 4], "gamma": 0.5,
                           "restarts": [5], "restart_weights": [0.5]}, "warmup_iter": 3},
            {}]
    for o in opts:
        j, t = jsched.build_schedule(o, 1e-4), tsched.build_schedule(o, 1e-4)
        for step in range(12):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6), (o, step)
    # the cosine with restarts: JAX evaluates it in float32 (cos and the
    # fraction), the port in float64, so they agree to float32's 1e-5
    cosines = [{"scheduler": {"type": "CosineAnnealingRestartLR", "periods": [4, 3, 5],
                              "restart_weights": [1.0, 0.5], "eta_min": 1e-6}},
               {"scheduler": {"type": "CosineAnnealingRestartLR", "periods": [5]},
                "warmup_iter": 2}]
    for o in cosines:
        j, t = jsched.build_schedule(o, 1e-4), tsched.build_schedule(o, 1e-4)
        for step in range(14):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-5, abs=1e-12), (o, step)
    for sched in (tsched, jsched):                      # refused by both packages
        with pytest.raises(NotImplementedError):
            sched.build_schedule({"scheduler": {"type": "LinearLR"}}, 1e-4)


def test_pretrained_generator_loads_from_reference_layout(tmp_path):
    """path.pretrain_network_g: a reference-layout ``{"params": state_dict}``
    file replaces the seeded init of G, and the EMA starts from it."""
    from ssl_tpu_torch.archs import RRDBNet
    from ssl_tpu_torch.models import build_model
    g_opt = {"type": "RRDBNet", "num_feat": 8, "num_block": 1, "num_grow_ch": 4}
    src = RRDBNet(num_feat=8, num_block=1, num_grow_ch=4)
    src.reset_parameters(torch.Generator().manual_seed(11))
    torch.save({"params": src.state_dict()}, tmp_path / "g.pth")
    opt = {"model_type": "SRModel", "scale": 4, "network_g": g_opt,
           "path": {"pretrain_network_g": str(tmp_path / "g.pth")},
           "train": {"ema_decay": 0.999, "optim_g": {"type": "Adam", "lr": 1e-4},
                     "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0}}}
    state = build_model(opt, device="cpu").init_state(seed=0)
    for k, v in src.state_dict().items():
        assert torch.equal(state.net_g.state_dict()[k], v), k
        assert torch.equal(state.net_g_ema.state_dict()[k], v), k
