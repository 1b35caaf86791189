"""Rules of the port package: it never imports JAX or the JAX package,
and its entry points refuse to fall back to the CPU when CUDA is
absent."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

PKG = Path(deeplearning4j_tpu_torch.__file__).resolve().parent


def _module_name(path: Path) -> str:
    parts = path.relative_to(PKG.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module_name(p) for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "deeplearning4j_tpu")


def test_no_module_imports_jax_or_the_jax_package():
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(PKG)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
        "in ('jax', 'jaxlib', 'deeplearning4j_tpu'))))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert len(MODULES) > 15
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_a_silent_cpu_default(no_cuda, tmp_path):
    lm = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                       n_heads=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(lm.conf())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_reference_model(tmp_path / "missing.zip")
    net = lm.init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(net)
    eng = ServingEngine(net, device="cpu")
    eng.shutdown()


def test_training_entry_points_run_on_the_network_device(no_cuda):
    lm = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                       n_heads=1, sparse_labels=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init().fit(np.zeros((1, 4), np.int64), np.zeros((1, 4), np.int64))
    net = lm.init(device="cpu")
    ids = np.zeros((2, 4), np.int64)
    net.fit(ids, ids)
    assert net._score.device.type == "cpu"
    assert np.isfinite(net.score(x=ids, y=ids))
    slots = net.opt_state["slots"]["layer_0"]["W"]
    assert all(t.device.type == "cpu" for t in slots.values())
