"""The port's training UI (``ui/``) against the JAX package's: the
statistics of one array and a listener's records over 3 fit steps of a
JAX-written TransformerLM, the storages' files (either package reads the
other's), every UIServer endpoint, the component DSL's HTML and JSON,
the embedding coordinates and the conv activation grid."""
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.ui as jui
from deeplearning4j_tpu.models.zoo import TransformerLM as JaxTransformerLM
from deeplearning4j_tpu.nn.conf.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.utils.model_serializer import write_model
from deeplearning4j_tpu_torch import ui as tui
from deeplearning4j_tpu_torch.models.zoo import TransformerLM
from deeplearning4j_tpu_torch.utils.model_serializer import \
    load_reference_model

SMALL = dict(vocab_size=11, seq_len=10, embed=32, n_layers=2, n_heads=4)
# f32 statistics of the same f32 data, summed in another order
TOL_SCALAR = 1e-6
# records of two nets 3 SGD steps apart from the same start
TOL_RECORD = 2e-5
# the attention's key bias: its exact gradient is 0 (a per-query constant
# under the softmax), so it moves by each package's rounding noise alone,
# and its statistics only show that both stay at the noise level
NOISE_ONLY = ("mha_bk",)


def _jax_stats(x):
    return jui.array_stats(jnp.asarray(x))


def _assert_stats_equal(got, want, tol, hist=True):
    assert set(got) == set(want)
    scale = max(abs(want["mean_magnitude"]), 1e-30)
    for k in ("mean", "std", "min", "max", "mean_magnitude", "norm2"):
        # relative to the value, or to the array's scale where the value
        # cancels towards 0 (the mean of a centred array)
        assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), scale), k
    if hist:
        assert got["hist"] == want["hist"]


@pytest.mark.parametrize("case", ["normal", "constant", "bin_edges",
                                  "bfloat16", "float16", "tensor"])
def test_array_stats_match_jax(case):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 7)).astype(np.float32)
    if case == "constant":             # the 1e-12 width clamp
        x = np.full((5, 6), 0.25, np.float32)
    elif case == "bin_edges":          # every value on an edge
        x = (np.arange(41, dtype=np.float32) / 40).reshape(41, 1)
    if case in ("bfloat16", "float16"):
        tdt = getattr(torch, case)
        got = tui.array_stats(torch.from_numpy(x).to(tdt))
        want = _jax_stats(jnp.asarray(x, getattr(jnp, case)))
    elif case == "tensor":
        got = tui.array_stats(torch.from_numpy(x))
        want = _jax_stats(x)
    else:
        got, want = tui.array_stats(x), _jax_stats(x)
    _assert_stats_equal(got, want, TOL_SCALAR)
    assert sum(got["hist"]) == x.size and len(got["hist"]) == 20


@pytest.fixture(scope="module")
def listened(tmp_path_factory):
    """3 fit steps of a small TransformerLM in both packages, each with a
    StatsListener: (port records, JAX records, port net, JAX net)."""
    jnet = JaxTransformerLM(**SMALL, updater=JaxSgd(learning_rate=0.01)).init()
    path = tmp_path_factory.mktemp("ui_lm") / "lm.zip"
    write_model(jnet, str(path))
    net = load_reference_model(path, device="cpu")
    tstore, jstore = tui.InMemoryStatsStorage(), jui.InMemoryStatsStorage()
    net.set_listeners(tui.StatsListener(tstore, session_id="s"))
    jnet.set_listeners(jui.StatsListener(jstore, session_id="s"))
    rng = np.random.default_rng(0)
    eye = np.eye(SMALL["vocab_size"], dtype=np.float32)
    for _ in range(3):
        ids = rng.integers(0, SMALL["vocab_size"], (4, SMALL["seq_len"]))
        y = eye[np.roll(ids, -1, axis=1)]
        net.fit(ids, y)
        jnet.fit(ids, y)
    return tstore.get_records("s"), jstore.get_records("s"), net, jnet


def _near_edge(x: np.ndarray, st: dict) -> bool:
    """True where a value lies within 2 ulp of one of the 19 inner bin
    edges: there the two packages' last bits may put it either side."""
    lo, hi = st["min"], st["max"]
    width = max(hi - lo, 1e-12)
    edges = lo + width * np.arange(1, 20) / 20
    x = x.reshape(-1, 1).astype(np.float64)
    return bool((np.abs(x - edges) <= 2 * np.spacing(
        np.abs(x).astype(np.float32)).astype(np.float64)).any())


def test_stats_listener_records_match_jax(listened):
    got, want, net, jnet = listened
    assert [r.iteration for r in got] == [r.iteration for r in want]
    assert len(got) == 3
    tree = jax.tree_util.tree_map(np.asarray, jnet.params)
    for g, w in zip(got, want):
        assert (g.session_id, g.worker_id, g.epoch) == \
            (w.session_id, w.worker_id, w.epoch)
        assert g.score == pytest.approx(w.score, rel=TOL_RECORD)
        assert set(g.param_stats) == set(w.param_stats)
        assert set(g.update_stats) == set(w.update_stats)
        for kind in ("param_stats", "update_stats"):
            for name, st in getattr(w, kind).items():
                layer, leaf = name.split("/")
                if leaf in NOISE_ONLY:
                    for s in (st, getattr(g, kind)[name]):
                        assert max(-s["min"], s["max"]) < 1e-6
                    continue
                hist = kind == "update_stats" or \
                    not _near_edge(tree[layer][leaf], st)
                _assert_stats_equal(getattr(g, kind)[name], st, TOL_RECORD,
                                    hist=hist and g is got[-1])
    assert not got[0].update_stats and got[1].update_stats
    assert set(got[0].memory) == {"host_rss_kb"}      # the CPU: RSS only


def test_listener_keeps_device_clones_and_copies_once(monkeypatch):
    """The previous parameters stay tensors on the network's device, and
    an iteration's statistics reach the host in one copy."""
    net = TransformerLM(**SMALL).init(device="cpu")
    lst = tui.StatsListener(tui.InMemoryStatsStorage(), session_id="c")
    net.set_listeners(lst)
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    ids = np.zeros((2, SMALL["seq_len"]), np.int64)
    y = np.eye(SMALL["vocab_size"], dtype=np.float32)[ids]
    net.fit(ids, y)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    net.fit(ids, y)
    monkeypatch.undo()
    n_params = sum(1 for g in net.params.values() for _ in g)
    # one copy: every param's and update's row and the score
    assert copies == [(2 * n_params * 26 + 1,)]
    assert all(torch.is_tensor(t) and t.device == net.device
               for _, t in lst._last_params.values())
    # the layers' same-shaped arrays share a stack
    assert len(lst._last_params) < n_params
    rec = lst.storage.get_records("c")[-1]
    assert rec.score == pytest.approx(net.get_score(), abs=0)


def _reports(mod, recs):
    return [mod.StatsReport.from_dict(json.loads(json.dumps(r.to_dict())))
            for r in recs]


def test_file_and_sqlite_storage_read_across_packages(listened, tmp_path):
    recs = listened[1]
    files = {}
    for name, mod in (("port", tui), ("jax", jui)):
        st = mod.FileStatsStorage(str(tmp_path / f"{name}.bin"))
        for r in _reports(mod, recs):
            st.put_record(r)
        st.close()
        files[name] = (tmp_path / f"{name}.bin").read_bytes()
    assert files["port"] == files["jax"]            # byte-equal logs
    want = [r.to_dict() for r in recs]
    for reader in (tui, jui):
        for name in ("port", "jax"):
            st = reader.FileStatsStorage(str(tmp_path / f"{name}.bin"))
            assert [r.to_dict() for r in st.get_records("s")] == want
            st.close()
    torn = tmp_path / "torn.bin"
    torn.write_bytes(files["port"][:-3])            # a crash mid-frame
    for reader in (tui, jui):
        st = reader.FileStatsStorage(str(torn))
        assert [r.to_dict() for r in st.get_records("s")] == want[:-1]
        st.close()
    db = str(tmp_path / "stats.db")
    port_db = tui.SqliteStatsStorage(db)
    for r in _reports(tui, recs[:2]):
        port_db.put_record(r)
    jax_db = jui.SqliteStatsStorage(db)
    jax_db.put_record(_reports(jui, recs[2:])[0])
    for st in (port_db, jax_db):
        assert [r.to_dict() for r in st.get_records("s")] == want
        assert st.list_session_ids() == ["s"]
        assert st.list_worker_ids("s") == ["worker_0"]
        assert st.get_latest_record("s").to_dict() == want[-1]


def _http(base, path, data=None, ctype="application/json"):
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_ui_server_endpoints_and_remote_router_equal_jax(listened):
    recs = listened[1]
    servers = {}
    for name, mod in (("port", tui), ("jax", jui)):
        store = mod.InMemoryStatsStorage()
        for r in _reports(mod, recs):
            store.put_record(r)
        srv = mod.UIServer(port=0).start()
        srv.attach(store)
        servers[name] = srv
    svg = ('<svg width="4" height="4" xmlns="http://www.w3.org/2000/svg">'
           '<rect x="0" y="0" width="2" height="2" fill="rgb(1,2,3)"/></svg>')
    report = dict(recs[0].to_dict(), session_id="remote", iteration=7)
    posts = [("/remote", json.dumps(report).encode()),
             ("/remote", b"not json"),
             ("/tsne/upload", b"1,2,a\n3,4,b\n"),
             ("/tsne/post/my%20set", b"0.5,0.25,w\n"),
             ("/tsne/bogus", b""),
             ("/activations", json.dumps({"iteration": 3,
                                          "svg": svg}).encode()),
             ("/activations", json.dumps({"svg": "<svg onload=x>"}).encode()),
             ("/nothing", b"{}")]
    gets = ["/", "/train/sessions", "/train/s/overview", "/train/s/model",
            "/train/s/system", "/train/s/report", "/train/s/param/layer_2/W",
            "/train/s/param/layer_2/mha_Wq", "/train/nope/overview",
            "/train/nope/model", "/train/nope/report", "/train/remote/model",
            "/tsne", "/tsne/sessions", "/tsne/coords/UploadedFile",
            "/tsne/coords/my%20set", "/tsne/nothing", "/activations",
            "/nothing", "/train/s"]
    try:
        got = {}
        for name, srv in servers.items():
            base = f"http://127.0.0.1:{srv.port}"
            got[name] = [_http(base, p, d) for p, d in posts] + \
                [_http(base, p) for p in gets]
        assert got["port"] == got["jax"]
        codes = [c for c, _ in got["port"]]
        assert codes[:len(posts)] == [200, 400, 200, 200, 404, 200, 400, 404]
        overview = json.loads(got["port"][len(posts) + 2][1])
        assert len(overview["scores"]) == 3
        # the port's remote router posts to either server
        rec = listened[0][-1]
        for srv in servers.values():
            tui.RemoteUIStatsStorageRouter(
                f"http://127.0.0.1:{srv.port}").put_record(rec)
            assert srv.storage.get_records("s")[-1].to_dict() == \
                rec.to_dict()
    finally:
        for srv in servers.values():
            srv.stop()


def _dsl(ui):
    rng = np.random.default_rng(0)
    line = (ui.ChartLine("loss", x_label="it", y_label="v",
                         style=ui.StyleChart(series_colors=["#123456"]))
            .add_series("train", [0, 1, 2], [3.0, 2.0, 1.0])
            .add_series("val", [0, 1, 2], [3.5, 2.5, 2.0]))
    scat = ui.ChartScatter("embed").add_series("pts", [0.1, 0.5],
                                               [0.2, 0.9])
    hist = ui.ChartHistogram.of(rng.standard_normal(500), n_bins=10,
                                title="weights")
    table = ui.ComponentTable(["metric", "value"], [["acc", 0.98],
                                                    ["f1", 0.97]],
                              title="eval",
                              style=ui.StyleTable(column_widths=[80, 60]))
    area = (ui.ChartStackedArea(title="memory by pool", x_label="step")
            .set_x([0, 1, 2, 3]).add_series("params", [1, 1, 1, 1])
            .add_series("activations", [0, 2, 3, 1]))
    tl = (ui.ChartTimeline(title="phases")
          .add_lane("etl", [(0.0, 1.5, "load")])
          .add_lane("train", [(1.5, 6.0, "fit"), (6.0, 7.0, "eval")]))
    bars = (ui.ChartHorizontalBar(title="per-class F1",
                                  style=ui.StyleChart(width=400, height=200))
            .add_bar("setosa", 1.0).add_bar("versicolor", 0.93)
            .add_bar("virginica", -0.1))
    div = ui.ComponentDiv(style=ui.StyleDiv(width=860, margin_px=4)).add(
        ui.ComponentText("grouped <b>", style=ui.StyleText(
            font_size=20, bold=True, color="#ff0000")), bars)
    acc = ui.DecoratorAccordion(
        title="details", default_collapsed=True,
        style=ui.StyleAccordion(title_color="#00ff00")).add(tl, hist)
    return [ui.ComponentText("Training report", bold=True), line, scat,
            table, area, div, acc]


def test_components_html_and_json_equal_jax():
    mine, theirs = _dsl(tui), _dsl(jui)
    page = tui.render_page(mine, title="r <1>")
    assert page == jui.render_page(theirs, title="r <1>")
    for a, b in zip(mine, theirs):
        js = tui.component_to_json(a)
        assert js == jui.component_to_json(b)
        assert jui.component_from_json(js).render() == a.render()
        back = tui.component_from_json(js)
        assert type(back) is type(a) and back.render() == a.render()


def test_embedding_coords_and_scatter_match_jax():
    v = np.random.default_rng(1).standard_normal((30, 8))
    np.testing.assert_allclose(tui.embedding_coords(v, "pca"),
                               jui.embedding_coords(v, "pca"), atol=1e-10,
                               rtol=0)
    lines = tui.coords_to_csv_lines(v[:4, :2], ["a,b", "c\nd", "e", "f"])
    assert lines == jui.coords_to_csv_lines(v[:4, :2],
                                            ["a,b", "c\nd", "e", "f"])


def test_embedding_coords_tsne_runs_the_port_tsne_on_the_named_device(
        monkeypatch):
    import deeplearning4j_tpu_torch.clustering as clustering
    seen = []
    real = clustering.Tsne

    class Spy(real):
        def __init__(self, *a, **k):
            seen.append(k.get("device"))
            super().__init__(*a, **k)

    monkeypatch.setattr(clustering, "Tsne", Spy)
    v = np.random.default_rng(2).standard_normal((12, 5))
    got = tui.embedding_coords(v, "tsne", max_iter=20, device="cpu")
    assert seen == ["cpu"] and got.shape == (12, 2)
    assert np.isfinite(got).all()


def test_convolutional_listener_svg_equals_jax(tmp_path):
    from deeplearning4j_tpu.nn.conf.input_type import InputType
    from deeplearning4j_tpu.nn.conf.multi_layer import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.updaters import Sgd
    from deeplearning4j_tpu.nn.layers.convolution import ConvolutionLayer
    from deeplearning4j_tpu.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu.nn.layers.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.train.listeners import \
        ConvolutionalIterationListener as JaxConvListener
    from deeplearning4j_tpu_torch.train.listeners import \
        ConvolutionalIterationListener
    from deeplearning4j_tpu_torch.ui.components import activation_grid_svg
    conf = (NeuralNetConfiguration.builder().seed(0)
            .updater(Sgd(learning_rate=0.05)).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    activation="relu",
                                    convolution_mode="same"))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    jnet = MultiLayerNetwork(conf).init()
    write_model(jnet, str(tmp_path / "cnn.zip"))
    net = load_reference_model(tmp_path / "cnn.zip", device="cpu")
    probe = np.random.default_rng(0).standard_normal(
        (1, 8, 8, 1)).astype(np.float32)
    mine = ConvolutionalIterationListener(probe, frequency=2)
    theirs = JaxConvListener(probe, frequency=2)
    mine.iteration_done(net, 0, 0)
    theirs.iteration_done(jnet, 0, 0)
    assert mine.rendered == theirs.rendered and "<svg" in mine.rendered[0]
    a = np.random.default_rng(4).standard_normal((2, 5, 6, 3))
    assert activation_grid_svg(a) == jui.components.activation_grid_svg(a)
