"""The program's model configuration from a configuration file.

The file's published keys (``hidden_size``, ``num_attention_heads``, ...)
are mapped to the port's ``ModelConfig`` fields, each where the file has
it. An optional ``"port"`` object then sets any ``ModelConfig`` field by
its own name: a nested object builds the nested dataclass (``"ssm": {...}``
an ``SSMConfig``), merged over what the published keys gave
(``"moe": {"group_size": 256}`` keeps the published experts). Names and
types come from the dataclasses themselves, so a field the port adds later
needs no edit here; a name that is no field is refused with the file's
name. ``"port": {"family": ...}`` names the port's family where the
file's top-level ``family`` names a reference of its own
(``reference/<family>.py``).
"""
from __future__ import annotations

import dataclasses
import types
import typing

# published key → ModelConfig field
PUBLISHED = {
    "name": "name", "family": "family", "num_hidden_layers": "num_layers",
    "hidden_size": "d_model", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size", "qk_norm": "qk_norm",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
}
# published key → MoEConfig field
PUBLISHED_MOE = {"num_local_experts": "num_experts", "num_experts_per_tok": "top_k"}

# where a configuration came from (set by ``bench.load_config``)
ROOT_KEY, FILE_KEY = "_root", "_file"


def _where(cfg: dict) -> str:
    """The configuration's file, or its name where it was built in code."""
    return cfg.get(FILE_KEY) or f"configuration {cfg.get('name')!r}"


def port_config(cfg: dict):
    """The ``repro_torch`` ``ModelConfig`` of a configuration file: its
    published keys, then its ``"port"`` object. Raises ValueError for a
    ``"port"`` name that is no field, or a value of the wrong type."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    kw = {field: cfg[key] for key, field in PUBLISHED.items() if key in cfg}
    if "qk_norm" in kw:
        kw["qk_norm"] = bool(kw["qk_norm"])
    if cfg.get("num_local_experts"):
        kw["moe"] = MoEConfig(**{field: cfg[key] for key, field in PUBLISHED_MOE.items()
                                 if key in cfg})
    port = cfg.get("port", {})
    if not isinstance(port, dict):
        raise ValueError(f"{_where(cfg)}: 'port' is {type(port).__name__}, not an object")
    kw.update(_fields(ModelConfig, port, kw, _where(cfg), "port"))
    try:
        return ModelConfig(**kw)
    except TypeError as e:
        raise ValueError(f"{_where(cfg)}: {e}") from None


def _fields(cls, given: dict, base: dict, file: str, path: str) -> dict:
    """``given``'s values for the fields of dataclass ``cls``, each checked
    against its type; a nested dataclass is merged over ``base``'s."""
    hints = typing.get_type_hints(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    out = {}
    for name, value in given.items():
        if name not in names:
            raise ValueError(f"{file}: {path}.{name} is no field of {cls.__name__} "
                             f"(its fields: {', '.join(names)})")
        out[name] = _value(hints[name], value, base.get(name), file, f"{path}.{name}")
    return out


def _value(tp, value, base, file: str, path: str):
    """``value`` as a field of type ``tp``: None where the type allows it, a
    dataclass built from an object (over ``base``, where there is one), an
    int where a float is asked for widened; else as given, if its type fits."""
    args = typing.get_args(tp)
    union = typing.get_origin(tp) in (typing.Union, types.UnionType)
    options = [a for a in args if a is not type(None)] if union else [tp]
    if value is None and len(options) < len(args):
        return None
    for opt in options:
        if dataclasses.is_dataclass(opt) and isinstance(value, dict):
            own = isinstance(base, opt)
            kw = _fields(opt, value, vars(base) if own else {}, file, path)
            return dataclasses.replace(base, **kw) if own else opt(**kw)
        if opt is float and isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if opt is int and isinstance(value, int) and not isinstance(value, bool):
            return value
        if opt in (bool, str) and isinstance(value, opt):
            return value
        if typing.get_origin(opt) is tuple and isinstance(value, list):
            return tuple(value)         # a JSON list, as a frozen dataclass holds it
        if opt not in (float, int, bool, str) and not dataclasses.is_dataclass(opt) \
                and typing.get_origin(opt) is not tuple:
            return value                # a type this check does not know: as given
    raise ValueError(f"{file}: {path} is {value!r}, not of type {tp}")
