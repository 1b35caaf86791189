"""Read the JAX package's ``@class``-tagged config JSON.

A copy of the reader in ``deeplearning4j_tpu/utils/serde.py``.  The
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
