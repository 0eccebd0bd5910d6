"""Experiment configuration.

Behavioral parity with the reference config system (utils/config.py:11-157 in
the reference): YAML files hold named sections (DATA/TRAIN/...) whose keys are
flattened into a single attribute-accessible namespace; CLI overrides arrive
as ``--opts key value ...`` pairs with literal-eval type coercion.
"""

from __future__ import annotations

import copy
import os
from ast import literal_eval

import yaml


class CfgNode(dict):
    """A dict with attribute access, the single config namespace for a run."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        for k, v in init_dict.items():
            if type(v) is dict:
                init_dict[k] = CfgNode(v)
        super().__init__(init_dict)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def get(self, name, default=None):
        return dict.get(self, name, default)

    def __str__(self):
        lines = []
        for k, v in sorted(self.items()):
            lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self):
        return f"{self.__class__.__name__}({dict.__repr__(self)})"


def load_cfg_from_cfg_file(file: str) -> CfgNode:
    """Load a YAML config, flattening all top-level sections into one namespace.

    Matches reference ``load_cfg_from_cfg_file`` (utils/config.py:61-74): every
    top-level key must map to a section dict; section names themselves are
    discarded and later sections override earlier duplicate keys.
    """
    cfg = {}
    assert os.path.isfile(file) and file.endswith(".yaml"), (
        f"{file} is not a yaml file"
    )
    with open(file) as f:
        cfg_from_file = yaml.safe_load(f)
    for section in cfg_from_file:
        for k, v in cfg_from_file[section].items():
            cfg[k] = v
    return CfgNode(cfg)


def merge_cfg_from_list(cfg: CfgNode, cfg_list) -> CfgNode:
    """Apply ``--opts key value`` overrides (reference utils/config.py:77-88).

    Keys may be dotted; only the last component is used.  Values go through
    literal_eval and must type-match the existing entry (list/tuple coerced).
    """
    new_cfg = copy.deepcopy(cfg)
    assert len(cfg_list) % 2 == 0, "--opts must be key/value pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        subkey = full_key.split(".")[-1]
        assert subkey in cfg, f"Non-existent key: {full_key}"
        value = _decode_cfg_value(v)
        value = _coerce_cfg_value_type(value, cfg[subkey], full_key)
        setattr(new_cfg, subkey, value)
    return new_cfg


def _decode_cfg_value(v):
    if not isinstance(v, str):
        return v
    try:
        v = literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    return v


def _coerce_cfg_value_type(replacement, original, full_key):
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None:
        return replacement
    # list <-> tuple are interchangeable on the CLI
    for from_type, to_type in ((tuple, list), (list, tuple)):
        if replacement_type == from_type and original_type == to_type:
            return to_type(replacement)
    raise ValueError(
        f"Type mismatch ({original_type} vs. {replacement_type}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}"
    )
