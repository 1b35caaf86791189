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
from deeplearning4j_tpu_torch.models.zoo import (ResNet50, TextGenerationLSTM,
                                                 TransformerLM)
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
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
    # the rest-of-training slice's modules are among those imported
    assert {"deeplearning4j_tpu_torch.nn.conf.schedules",
            "deeplearning4j_tpu_torch.nn.conf.constraints",
            "deeplearning4j_tpu_torch.nn.conf.distribution",
            "deeplearning4j_tpu_torch.nn.weights",
            "deeplearning4j_tpu_torch.nn.transfer_learning",
            "deeplearning4j_tpu_torch.train.listeners",
            "deeplearning4j_tpu_torch.evaluation.classification",
            "deeplearning4j_tpu_torch.evaluation.regression",
            "deeplearning4j_tpu_torch.evaluation.roc",
            "deeplearning4j_tpu_torch.earlystopping.trainer",
            "deeplearning4j_tpu_torch.earlystopping.savers",
            # the precision and memory slice's
            "deeplearning4j_tpu_torch.nn.precision",
            "deeplearning4j_tpu_torch.nn.conf.memory",
            "deeplearning4j_tpu_torch.train.solvers",
            "deeplearning4j_tpu_torch.evaluation.binary",
            "deeplearning4j_tpu_torch.evaluation.calibration",
            "deeplearning4j_tpu_torch.evaluation.tools",
            # the serving tier's
            "deeplearning4j_tpu_torch.utils.http",
            "deeplearning4j_tpu_torch.utils.profiling",
            "deeplearning4j_tpu_torch.parallel.inference",
            "deeplearning4j_tpu_torch.serving.inference_server",
            "deeplearning4j_tpu_torch.serving.tenancy",
            "deeplearning4j_tpu_torch.serving.fleet",
            "deeplearning4j_tpu_torch.serving.nn_server",
            "deeplearning4j_tpu_torch.clustering.neighbors"} <= set(MODULES)
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


def test_cnn_slice_modules_are_checked():
    for m in ("ops.pallas_bn", "nn.computation_graph",
              "nn.conf.computation_graph", "nn.layers.convolution",
              "nn.layers.normalization", "nn.layers.pooling"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES
    assert (PKG / "csrc" / "bn_apply.cu").is_file()


def test_graph_entry_points_refuse_a_silent_cpu_default(no_cuda):
    small = ResNet50(num_classes=4, input_shape=(32, 32, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(small.conf())
    net = small.init(device="cpu")
    assert net.device.type == "cpu"
    assert all(t.device.type == "cpu" for g in net.state.values()
               for t in g.values())


def test_rnn_slice_modules_are_checked():
    for m in ("ops.pallas_lstm", "nn.layers.recurrent", "nn.multilayer",
              "nn.activations", "nn.layers.base", "models.zoo"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES
    assert (PKG / "csrc" / "lstm_fwd.cu").is_file()


def test_rnn_entry_points_refuse_a_silent_cpu_default(no_cuda):
    small = TextGenerationLSTM(num_classes=6, timesteps=4, hidden=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(small.conf())
    net = small.init(device="cpu")
    x = np.eye(6, dtype=np.float32)[np.zeros((2, 4), np.int64)]
    y = net.rnn_time_step(x)
    assert y.device.type == "cpu" and y.shape == (2, 4, 6)
    carries = net.rnn_get_previous_state(0)
    assert all(t.device.type == "cpu" for t in carries.values())


def test_generation_slice_modules_are_checked():
    for m in ("generation", "generation.engine", "generation.cache",
              "generation.programs", "generation.sampling",
              "utils._random", "observability.clock",
              "observability.quantiles", "data.shapes"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES


def test_generation_entry_points_refuse_a_silent_cpu_default(no_cuda):
    from deeplearning4j_tpu_torch.generation import (GenerationConfig,
                                                     GenerationEngine)
    from deeplearning4j_tpu_torch.generation.cache import PagedKV
    lm = TransformerLM(vocab_size=8, seq_len=8, embed=8, n_layers=1,
                       n_heads=1)
    net = lm.init(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKV(net.conf, max_slots=1, max_seq=8)
    kv = PagedKV(net.conf, max_slots=1, max_seq=8, device="cpu")
    assert kv.caches["layer_2"]["kp"].device.type == "cpu"
    eng = GenerationEngine.for_model(net, GenerationConfig(max_slots=1,
                                                           max_seq=8))
    try:
        res = eng.generate([1, 2], max_new_tokens=2, timeout=60)
        assert len(res.tokens) == 2
        assert eng.status()["device"] == "cpu"
    finally:
        eng.shutdown()


def test_conv_zoo_slice_modules_are_checked():
    for m in ("utils._random", "nn.conf.dropout", "nn.conf.preprocessors",
              "nn.layers.misc", "nn.layers.feedforward", "models.zoo"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES


@pytest.mark.parametrize("name", ["LeNet", "GoogLeNet"])
def test_zoo_entry_points_refuse_a_silent_cpu_default(no_cuda, name):
    from deeplearning4j_tpu_torch.models import zoo
    small = getattr(zoo, name)(num_classes=3, input_shape=(28, 28, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small.init()
    net = small.init(device="cpu")
    assert net.device.type == "cpu" and net._rng.device.type == "cpu"
    x = np.zeros((2, 28 * 28) if name == "LeNet" else (2, 28, 28, 1),
                 np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1]]
    net.fit(x, y)
    assert net._score.device.type == "cpu"
    assert net.output(x).shape == (2, 3)


def test_serving_tier_entry_points_refuse_a_silent_cpu_default(no_cuda):
    from deeplearning4j_tpu_torch.clustering import BruteForceNN
    from deeplearning4j_tpu_torch.serving import (InferenceServer,
                                                  NearestNeighborsServer,
                                                  ServingFleet,
                                                  ServingServer)
    net = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                        n_heads=1).init(device="cpu")
    points = np.zeros((4, 2), np.float32)
    for make in (lambda: ServingServer(),
                 lambda: ServingEngine(),
                 lambda: InferenceServer(net),
                 lambda: ServingFleet(net),
                 lambda: NearestNeighborsServer(points),
                 lambda: BruteForceNN(points)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_device_platform_names_the_serving_device():
    from deeplearning4j_tpu_torch.utils.profiling import device_platform
    assert device_platform("cpu") == "cpu"
    assert device_platform(torch.device("cuda", 0)) == "gpu"
    assert device_platform("meta") == "unknown"


def test_serving_exports_the_jax_package_names():
    import deeplearning4j_tpu.serving as jserving

    import deeplearning4j_tpu_torch.serving as tserving
    assert tserving.__all__ == jserving.__all__
    assert all(hasattr(tserving, name) for name in tserving.__all__)


def test_parallel_slice_modules_are_checked():
    for m in ("parallel.mesh", "parallel.exchange", "parallel.wrapper",
              "parallel.sharded", "parallel.distributed",
              "parallel.accumulation", "parallel.remote", "parallel.master",
              "parallel.layer", "nn.sparse", "utils.global_batch",
              "utils.native", "streaming.broker", "parallel.collectives",
              "parallel.sequence", "parallel.pipeline", "parallel.expert",
              "parallel.demo", "parallel.dryrun", "nn.layers.moe"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES


def test_parallel_exports_the_jax_package_names_of_this_slice():
    """The port's ``parallel`` exports every name of the JAX package's
    (pipeline, sequence and expert parallelism since the model-axes
    slice), and every export resolves."""
    import deeplearning4j_tpu.parallel as jparallel

    import deeplearning4j_tpu_torch.parallel as tparallel
    assert set(jparallel.__all__) - set(tparallel.__all__) == set()
    assert all(getattr(tparallel, name) is not None
               for name in tparallel.__all__)


def test_parallel_entry_points_refuse_a_silent_cpu_default(no_cuda):
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu_torch.parallel import (DistributedLayerTrainer,
                                                   ParallelWrapper,
                                                   ShardedTrainer)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedLayerTrainer(OutputLayer(n_out=2, activation="softmax"),
                                input_size=3)
    # a wrapper trains its network on the network's own device
    net = TransformerLM(vocab_size=8, seq_len=4, embed=8, n_layers=1,
                        n_heads=1).init(device="cpu")
    for w in (ParallelWrapper(net), ShardedTrainer(net)):
        assert w.mesh.device.type == "cpu" and w.mesh.dp == 1


def test_process_master_modules_are_checked():
    """The process masters, their worker entry (``python -m`` of the same
    module) and the TCP broker are among the modules the two tests above
    hold to no JAX import (``tests/test_torch_masters_mp.py`` checks the
    spawned worker's own import log)."""
    for m in ("parallel.master_mp", "streaming.broker", "streaming",
              "parallel.remote", "parallel.exchange"):
        assert f"deeplearning4j_tpu_torch.{m}" in MODULES
    from deeplearning4j_tpu_torch.parallel import master_mp
    assert master_mp.MultiprocessMaster._WORKER_MODULE == \
        "deeplearning4j_tpu_torch.parallel.master_mp"
    src = Path(master_mp.__file__).read_text()
    assert 'if __name__ == "__main__":' in src

