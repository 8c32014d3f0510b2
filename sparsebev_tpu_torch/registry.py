"""String-keyed component registries + config-driven ``build`` (the port's
own copy of ``sparsebev_tpu/registry.py``, which the port does not import):
components register under a name, and configs instantiate them with
``dict(type='Name', **kwargs)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A simple name -> callable registry.

    Usage::

        MODELS = Registry('models')

        @MODELS.register_module()
        class Foo: ...

        foo = MODELS.build(dict(type='Foo', arg=1))
    """

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Callable]:
        return dict(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __len__(self) -> int:
        return len(self._module_dict)

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._module_dict)})"

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None,
                        force: bool = False):
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str], force: bool):
        if not callable(module):
            raise TypeError(f"module must be callable, got {type(module)}")
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f"{key} is already registered in {self._name}")
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        return build(cfg, self, **default_kwargs)


def build(cfg: Dict[str, Any], registry: Registry, **default_kwargs) -> Any:
    """Instantiate ``registry[cfg['type']](**cfg_without_type, **defaults)``.

    ``default_kwargs`` only fill keys absent from ``cfg``. ``cfg['type']`` may
    also be a callable, in which case the registry is bypassed.
    """
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        raise KeyError(f"cfg must contain the key 'type': {cfg}")
    args = dict(cfg)
    obj_type = args.pop("type")
    for k, v in default_kwargs.items():
        args.setdefault(k, v)
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not registered in {registry.name}; "
                           f"available: {sorted(registry.module_dict)}")
    elif callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or callable, got {type(obj_type)}")
    try:
        return obj_cls(**args)
    except TypeError as e:
        raise TypeError(f"failed to build {obj_type} from {registry.name}: {e}") from e


def build_from_cfg(cfg, registry, default_args=None):
    """mm*-style alias of :func:`build` taking ``default_args`` as a dict."""
    return build(cfg, registry, **(default_args or {}))


# the port builds its models from configs directly (models/detector.py);
# the training loop's hooks, the datasets and the data pipeline's steps are
# looked up by name
HOOKS = Registry("hooks")
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
