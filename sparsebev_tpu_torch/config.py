"""Python-file config system with `_base_` inheritance, `_delete_`, and
dotted-path overrides (the port's own copy of ``sparsebev_tpu/config.py``,
so the torch package imports nothing from the JAX package).

- configs are plain Python files whose top-level variables form the config;
- ``_base_ = ['../other.py']`` merges parent configs (child wins);
- a dict containing ``_delete_: True`` replaces instead of merges;
- ``Config.merge_from_dict({'a.b.c': v})`` applies dotted-path overrides
  (the ``--override`` CLI flag).
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, Optional

_DELETE_KEY = "_delete_"
_BASE_KEY = "_base_"


class ConfigDict(dict):
    """dict with attribute access (cfg.model.type)."""

    def __getattr__(self, name):
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name)
        return value

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({copy.deepcopy(k, memo): copy.deepcopy(v, memo)
                           for k, v in self.items()})


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_dict(base: dict, child: dict) -> dict:
    """Recursively merge ``child`` on top of ``base`` (child wins)."""
    out = dict(base)
    for k, v in child.items():
        if isinstance(v, dict):
            v = dict(v)
            if v.pop(_DELETE_KEY, False):
                out[k] = v  # _delete_: replace wholesale
            elif isinstance(out.get(k), dict):
                out[k] = _merge_dict(out[k], v)
            else:
                out[k] = v
        else:
            out[k] = v
    return out


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    with open(filename, "r") as f:
        code = f.read()
    module = types.ModuleType("_cfg_" + os.path.basename(filename).replace(".", "_"))
    module.__file__ = filename
    exec(compile(code, filename, "exec"), module.__dict__)
    cfg = {k: v for k, v in module.__dict__.items()
           if not k.startswith("__") and not isinstance(v, types.ModuleType)
           and not callable(v)}
    return cfg


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases = cfg.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
    for base in bases:
        base_cfg = _load_with_bases(os.path.join(cfg_dir, base))
        merged = _merge_dict(merged, base_cfg)
    return _merge_dict(merged, cfg)


def _parse_value(value: str) -> Any:
    """Parse a CLI override value: try Python literal, fall back to str."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
        if value.lower() in ("none", "null"):
            return None
        return value


class Config:
    """Top-level config object (attribute access + file/dict constructors)."""

    def __init__(self, cfg_dict: Optional[Dict[str, Any]] = None, filename: Optional[str] = None):
        self._cfg_dict = _to_config_dict(cfg_dict or {})
        self._filename = filename

    @classmethod
    def fromfile(cls, filename: str) -> "Config":
        return cls(_load_with_bases(filename), filename=filename)

    @classmethod
    def fromdict(cls, d: Dict[str, Any]) -> "Config":
        return cls(copy.deepcopy(d))

    # -- attribute / item access ------------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._cfg_dict[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = _to_config_dict(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg_dict))

    # -- CLI override ------------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """Apply ``{'a.b.c': value}`` dotted-path overrides in place."""
        for full_key, value in options.items():
            if isinstance(value, str):
                value = _parse_value(value)
            keys = full_key.split(".")
            node = self._cfg_dict
            for key in keys[:-1]:
                if key not in node or not isinstance(node[key], dict):
                    node[key] = ConfigDict()
                node = node[key]
            node[keys[-1]] = _to_config_dict(value)

    def dump(self) -> str:
        import pprint
        return pprint.pformat(dict(self._cfg_dict), width=100, sort_dicts=False)

    def __repr__(self):
        return f"Config(file={self._filename}):\n{self.dump()}"
