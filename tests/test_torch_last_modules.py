"""The port's package surface and its last modules against the JAX
package: every ``__all__`` name of the package, ``models``, ``nn.layers``,
``streaming`` and ``ui`` resolves in the port (but the deferred ones),
the package's exports import lazily, ``utils.model_guesser`` sniffs and
loads what the JAX package writes, and ``provision`` emits its commands
for a GPU host and runs none unasked."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu_torch
from deeplearning4j_tpu.nn.computation_graph import \
    ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.conf.computation_graph import ElementWiseVertex
from deeplearning4j_tpu.nn.conf.input_type import InputType
from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
from deeplearning4j_tpu.nn.layers.feedforward import DenseLayer, OutputLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.utils.model_serializer import write_model

REPO = Path(__file__).resolve().parents[1]
# names the JAX package exports that the port does not have yet, each
# with the work that brings it
DEFERRED = {
    "persistent_cache_status",   # nn/compile_cache.py: compile/dispatch work
    "wire_persistent_cache",     # nn/compile_cache.py: compile/dispatch work
    "available_bench_model",     # utils/benchmarks.py: the first benchmark
    "flagship_entry_model",      # utils/benchmarks.py: the first benchmark
}
# a loaded net's rows against the JAX net's, f32 on the same weights
TOL_ROWS = 2e-5


@pytest.mark.parametrize("pkg", ["", ".models", ".nn.layers", ".streaming",
                                 ".ui"])
def test_every_jax_export_resolves_in_the_port(pkg):
    jax_mod = importlib.import_module("deeplearning4j_tpu" + pkg)
    mod = importlib.import_module("deeplearning4j_tpu_torch" + pkg)
    missing = [n for n in jax_mod.__all__
               if n not in DEFERRED and getattr(mod, n, None) is None]
    assert missing == []
    assert set(mod.__all__) == set(jax_mod.__all__) - DEFERRED
    for name in mod.__all__:
        if name[0].isupper() and name not in ("ALL_MODELS",):
            assert getattr(mod, name).__module__.startswith(
                "deeplearning4j_tpu_torch")
    with pytest.raises(AttributeError):
        getattr(mod, "NoSuchName")


def test_package_exports_import_lazily():
    code = (
        "import sys\n"
        "import deeplearning4j_tpu_torch as t\n"
        "print(sorted(m for m in sys.modules if m.startswith("
        "'deeplearning4j_tpu_torch.')))\n"
        "import deeplearning4j_tpu_torch.streaming.kafka_wire\n"
        "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.stdout.split("\n")[:2] == ["[]", "False"]
    # a name imports its module on first access
    assert deeplearning4j_tpu_torch.MultiLayerNetwork.__module__ == \
        "deeplearning4j_tpu_torch.nn.multilayer"
    assert deeplearning4j_tpu_torch.__version__ == "0.1.0"


def test_no_port_module_imports_google_crc32c():
    """The Kafka wire's CRC-32C comes from the native codec (or its
    Python twin): ``google_crc32c`` is not on the card's machine."""
    import ast
    pkg = Path(deeplearning4j_tpu_torch.__file__).resolve().parent
    found = []
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            found += [str(path) for n in names if "crc32c" in n]
    assert found == []


def _mln():
    conf = (NeuralNetConfiguration.builder().seed(3).activation("tanh")
            .list().layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _graph():
    conf = (NeuralNetConfiguration.builder().seed(4)
            .graph_builder().add_inputs("in")
            .add_layer("d0", DenseLayer(n_out=6, activation="tanh"), "in")
            .add_layer("d1", DenseLayer(n_out=6, activation="tanh"), "d0")
            .add_vertex("skip", ElementWiseVertex(op="add"), "d0", "d1")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax",
                                          loss="mcxent"), "skip")
            .set_outputs("out").set_input_types(InputType.feed_forward(4))
            .build())
    return JaxGraph(conf).init()


def test_model_guesser_sniffs_and_loads_what_jax_writes(tmp_path):
    import deeplearning4j_tpu.ui as jui
    from deeplearning4j_tpu.utils import model_guesser as jmg

    from deeplearning4j_tpu_torch.utils import model_guesser as tmg
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    files = {}
    for name, make in (("mln", _mln), ("graph", _graph)):
        net = make()
        files[name] = (tmp_path / f"{name}.zip", net)
        write_model(net, str(files[name][0]))
    w2v = tmp_path / "vectors.txt"
    w2v.write_text("3 4\nthe 0.1 0.2 0.3 0.4\ncat -1 0.5 2 0\n"
                   "sat 0 0 0.25 -0.75\n")
    log = tmp_path / "stats.bin"
    st = jui.FileStatsStorage(str(log))
    st.put_record(jui.StatsReport(session_id="s", worker_id="w",
                                  iteration=1, epoch=0, timestamp=0.0,
                                  score=0.5, iter_time_ms=1.0))
    st.close()
    other = tmp_path / "notes.bin"
    other.write_bytes(b"\x00\x01 no format")
    kinds = {}
    for path in (files["mln"][0], files["graph"][0], w2v, log, other):
        kinds[path.name] = tmg.guess_format(str(path))
        assert kinds[path.name] == jmg.guess_format(str(path))
    assert list(kinds.values()) == ["multi_layer_network",
                                    "computation_graph", "word_vectors",
                                    "stats_log", "unknown"]
    for name in ("mln", "graph"):
        path, jnet = files[name]
        net = tmg.load_model_guess(str(path), device="cpu")
        assert type(net).__name__ == type(jnet).__name__
        assert net.device.type == "cpu"
        got = net.output(x)
        want = jnet.output(x)
        if name == "graph":
            got, want = got[0], want[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_ROWS, rtol=0)
    vec = tmg.load_model_guess(str(w2v), device="cpu")
    jvec = jmg.load_model_guess(str(w2v))
    for word in ("the", "cat", "sat"):
        np.testing.assert_array_equal(np.asarray(vec.get_word_vector(word)),
                                      np.asarray(jvec.get_word_vector(word)))
    stats = tmg.load_model_guess(str(log))
    assert [r.to_dict() for r in stats.get_records("s")] == \
        [r.to_dict() for r in jmg.load_model_guess(str(log))
         .get_records("s")]
    stats.close()
    with pytest.raises(ValueError, match="cannot determine"):
        tmg.load_model_guess(str(other))
    with pytest.raises(FileNotFoundError):
        tmg.guess_format(str(tmp_path / "missing"))


def test_provision_emits_gpu_host_commands_and_runs_none(monkeypatch):
    from deeplearning4j_tpu import provision as jprov

    from deeplearning4j_tpu_torch import provision as tprov

    def refuse(*a, **k):
        raise AssertionError("a command ran")

    monkeypatch.setattr(subprocess, "run", refuse)
    for bucket in ("models", "gs://models/"):
        mine, theirs = tprov.StorageTransfer(bucket), \
            jprov.StorageTransfer(bucket)
        assert mine.upload_command("ckpt", "run1/ckpt") == \
            theirs.upload_command("ckpt", "run1/ckpt")
        assert mine.download_command("run1/ckpt", "here") == \
            theirs.download_command("run1/ckpt", "here")
        cmd = mine.upload_command("a", "b")
        assert mine.run(cmd) == cmd
    spec = tprov.ClusterSpec(name="trainer", project="p", preemptible=True,
                             tags={"team": "ml", "env": "dev"})
    setup = tprov.TpuClusterSetup(spec)
    script = setup.render()
    assert script.startswith("gcloud compute instances create trainer ")
    assert "--machine-type=a3-highgpu-1g" in script    # one H100 80GB
    assert "--labels=env=dev,team=ml" in script
    assert "--provisioning-model=SPOT" in script
    assert "tpu" not in script
    assert setup.apply() == setup.create_command()
    # the JAX package's fields, and no other
    assert [f.name for f in dataclasses.fields(tprov.ClusterSpec)] == \
        [f.name for f in dataclasses.fields(jprov.ClusterSpec)]
    assert setup.delete_command()[:4] == ["gcloud", "compute", "instances",
                                          "delete"]
    assert setup.ssh_command(remote_command="nvidia-smi")[-2:] == \
        ["--command", "nvidia-smi"]
    with pytest.raises(ValueError, match="one VM"):
        setup.ssh_command(worker="3")
    assert json.dumps(setup.describe_command())
