"""Read and write the JAX package's ``@class``-tagged config JSON.

A copy of ``deeplearning4j_tpu/utils/serde.py``: ``to_json`` writes
every registered dataclass as its fields under an ``@class`` tag, in
field order, so a port configuration writes the JSON the JAX package
writes for the same configuration, and reads back there.  The
registry holds only the classes this port has; any other ``@class``
raises, so a configuration the port cannot run fails when it is read.
Unknown fields of a known class are dropped with a warning, as in the
reference (version tolerance).
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, Type

log = logging.getLogger(__name__)

_CLASS_REGISTRY: Dict[str, Type] = {}


def register_serde(cls):
    """Class decorator: make a dataclass readable by its @class tag."""
    _CLASS_REGISTRY[cls.__name__] = cls
    return cls


def registered() -> list:
    return sorted(_CLASS_REGISTRY)


def lookup_class(name: str):
    """The registered class of an ``@class`` tag, or None."""
    return _CLASS_REGISTRY.get(name)


def to_jsonable(obj: Any) -> Any:
    """Registered dataclasses and containers as JSON-able values."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = to_jsonable(getattr(obj, f.name))
        return d
    # numpy / torch scalars and arrays
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    raise TypeError(f"cannot serialize {type(obj)}")


def to_json(obj: Any, indent: int = 2) -> str:
    return json.dumps(to_jsonable(obj), indent=indent)


def to_yaml(obj: Any) -> str:
    import yaml
    return yaml.safe_dump(to_jsonable(obj), sort_keys=False)


def from_yaml(s: str) -> Any:
    import yaml
    return from_jsonable(yaml.safe_load(s))


def from_jsonable(d: Any) -> Any:
    """Rebuild registered dataclasses from parsed ``@class`` JSON."""
    if isinstance(d, list):
        return [from_jsonable(v) for v in d]
    if isinstance(d, dict):
        if "@class" in d:
            name = d["@class"]
            cls = _CLASS_REGISTRY.get(name)
            if cls is None:
                raise ValueError(
                    f"@class '{name}' in config json is not ported to "
                    f"deeplearning4j_tpu_torch yet; ported: {registered()}")
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in d.items():
                if k == "@class":
                    continue
                if k not in field_names:
                    log.warning("dropping unknown field %s.%s during "
                                "deserialization", name, k)
                    continue
                kwargs[k] = from_jsonable(v)
            return cls(**kwargs)
        return {k: from_jsonable(v) for k, v in d.items()}
    return d


def from_json(s: str) -> Any:
    return from_jsonable(json.loads(s))
