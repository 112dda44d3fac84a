"""Minimal name->class registries (reference: basicsr/utils/registry.py:84-88).

Same surface as ``ssl_tpu/utils/registry.py``: DATASET / ARCH / MODEL / LOSS /
METRIC registries plus the ``build_*`` lookups by the option dict's ``type``
key."""

from __future__ import annotations

from copy import deepcopy


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, object] = {}

    def register(self, obj=None, name: str | None = None):
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"'{key}' already registered in '{self._name}'")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str):
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}")
        return self._obj_map[name]


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")


def build_network(opt: dict):
    """Instantiate an ``nn.Module`` from an option dict with a ``type`` key.

    Keys the constructor does not take are dropped, as in the JAX package
    (e.g. ``scale`` for a discriminator)."""
    import inspect

    from ssl_tpu_torch import archs as _archs  # noqa: F401  (populate registry)
    opt = deepcopy(opt)
    cls = ARCH_REGISTRY.get(opt.pop("type"))
    params = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in opt.items() if k in params})


def build_loss(opt: dict):
    """Instantiate a loss from an option dict with a ``type`` key."""
    from ssl_tpu_torch import losses as _losses  # noqa: F401  (populate registry)
    opt = deepcopy(opt)
    return LOSS_REGISTRY.get(opt.pop("type"))(**opt)


def build_model(opt: dict, device=None):
    """Instantiate a training recipe by ``model_type``.  ``device`` defaults
    to ``cuda``; CPU runs happen only when the caller passes ``"cpu"``."""
    from ssl_tpu_torch import models as _models  # noqa: F401  (populate registry)
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
