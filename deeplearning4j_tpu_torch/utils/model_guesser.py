"""Load any saved artifact by sniffing its format (port of
``utils/model_guesser.py``; reference
``deeplearning4j-core/.../util/ModelGuesser.java``): model zips (MLN or
ComputationGraph), word-vector files, and stats logs.  The sniffing is
the JAX package's; the loaders are the port's, and a network or vector
model lands on ``device``."""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any

__all__ = ["guess_format", "load_model_guess"]


def guess_format(path: str) -> str:
    """Returns one of: 'multi_layer_network', 'computation_graph',
    'word_vectors', 'stats_log', 'unknown'."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
    if head == b"DL4JTPU1":
        return "stats_log"
    if head[:2] == b"PK":  # zip container
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if "metadata.json" in names and "configuration.json" in names:
                try:
                    cls = json.loads(zf.read("metadata.json")).get(
                        "net_class", "")
                except (ValueError, AttributeError):
                    cls = ""
                if "Graph" in cls:
                    return "computation_graph"
                return "multi_layer_network"
        return "unknown"
    # word2vec text format: "<vocab> <dim>" header then "token floats..."
    try:
        with open(path, "r", errors="strict") as fh:
            first = fh.readline().split()
            if len(first) == 2 and first[0].isdigit() and first[1].isdigit():
                return "word_vectors"
            if len(first) > 2:
                float(first[1])
                return "word_vectors"
    except (UnicodeDecodeError, ValueError, IndexError):
        pass
    return "unknown"


def load_model_guess(path: str, device="cuda") -> Any:
    """Sniff + load (reference ``ModelGuesser.loadModelGuess``)."""
    kind = guess_format(path)
    if kind in ("multi_layer_network", "computation_graph"):
        from .model_serializer import restore_model
        return restore_model(path, device=device)
    if kind == "word_vectors":
        # full sniffing loader: txt/csv/binary/gzip variants
        from ..nlp.serializer import load_static_model
        return load_static_model(path, device=device)
    if kind == "stats_log":
        from ..ui.storage import FileStatsStorage
        return FileStatsStorage(path)
    raise ValueError(f"cannot determine artifact format of {path}")
