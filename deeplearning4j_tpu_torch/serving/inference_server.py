"""Model inference REST server (port of ``serving/inference_server.py``:
the serving role of reference
``dl4j-streaming/.../routes/DL4jServeRouteBuilder.java``, a plain HTTP
predict endpoint over :class:`ParallelInference`).

Endpoints:
  POST /predict  {"data": [[...], ...]}  -> {"output": [[...], ...]}
  POST /reload   {"path": "model.zip" | checkpoint dir} -> hot-swap
  GET  /health   liveness + readiness (platform, model identity,
                 seconds since the last successful predict)
  GET  /metrics  Prometheus text exposition (?format=json for a snapshot)
"""
from __future__ import annotations

import os

import numpy as np

from ..observability import clock
from ..observability.health import get_health_monitor
from ..observability.registry import default_registry
from ..parallel.inference import (InferenceMode, InvalidInputError,
                                  ParallelInference)
from ..utils.device import resolve_device
from ..utils.http import (BackgroundHttpServer, JsonClient, JsonHandler,
                          PredictCircuitMixin)
from ..utils.profiling import device_platform
from .engine import for_serving

__all__ = ["InferenceServer", "InferenceClient"]


class _PredictHandler(JsonHandler):
    server_ref = None

    def do_GET(self):
        if self._serve_metrics():
            return
        if self._serve_flightrecorder():
            return
        if self._serve_profile():
            return
        if self.path.rstrip("/") == "/health":
            return self._json(self.server_ref.health())
        return self._json({"error": "not found"}, 404)

    def do_POST(self):
        route = self.path.rstrip("/")
        if route == "/reload":
            try:
                body = self._read_json()
                self.server_ref.reload(body["path"])
            except Exception as e:
                return self._json({"error": str(e)}, 400)
            return self._json({"ok": True})
        if route != "/predict":
            return self._json({"error": "not found"}, 404)
        try:
            x = np.asarray(self._read_json()["data"], dtype=np.float32)
        except Exception as e:
            return self._json({"error": str(e)}, 400)
        srv = self.server_ref
        try:
            out = srv.inference.output(x)
        except InvalidInputError as e:  # up-front shape rejection only
            return self._json({"error": str(e)}, 400)
        except Exception as e:  # model-side failures are server errors
            srv.note_predict_result(False)
            return self._json({"error": str(e)}, 500)
        srv.note_predict_result(True)
        reg = self._registry()
        if reg.enabled:
            reg.counter("inference_examples_total",
                        "Examples served through /predict") \
               .inc(int(x.shape[0]) if x.ndim >= 2 else 1)
        return self._json({"output": np.asarray(out).tolist()})


def _model_identity(model, origin: str = "init") -> str:
    name = type(model).__name__
    try:
        n = model.num_params()   # shape metadata only: no device sync
        return f"{name}[params={n},from={origin}]"
    except Exception:
        return f"{name}[from={origin}]"


class InferenceServer(PredictCircuitMixin):
    """Per-request predict server over :class:`ParallelInference`; the
    model lives on ``device`` and every reload restores onto it."""

    # consecutive model-side (5xx) predict failures before /health flips
    # to unready
    FAILURE_THRESHOLD = 3

    def __init__(self, model, port: int = 0,
                 inference_mode: str = InferenceMode.BATCHED,
                 max_batch_size: int = 32, registry=None, device="cuda"):
        self.device = resolve_device(device)
        model_device = getattr(model, "device", None)
        if model_device is not None and model_device != self.device:
            raise ValueError(f"model is on {model_device}, the server on "
                             f"{self.device}")
        self._mode = inference_mode
        self._max_batch = max_batch_size
        self.inference = ParallelInference(model, inference_mode,
                                           max_batch_size=max_batch_size)
        self.registry = registry if registry is not None \
            else default_registry()
        self.platform = device_platform(self.device)
        self.model_id = _model_identity(model)
        # optional generation readiness feed (attach_generation)
        self.generation = None
        self._init_predict_circuit()
        self._server = BackgroundHttpServer(_PredictHandler, port,
                                            server_ref=self,
                                            metrics_registry=self.registry)

    def attach_generation(self, engine) -> "InferenceServer":
        """Surface a ``GenerationEngine``'s readiness in this server's
        ``/health``: generation unreadiness flips readiness the same way
        the predict circuit does."""
        self.generation = engine
        return self

    def health(self) -> dict:
        """Liveness vs readiness: answering at all is liveness; readiness
        means a loaded model with fewer than FAILURE_THRESHOLD consecutive
        model-side predict failures (and, attached, a ready generation
        engine)."""
        ready = (self.inference is not None
                 and self.platform != "unknown"
                 and self.consecutive_failures < self.FAILURE_THRESHOLD)
        gen_status = None
        if self.generation is not None:
            gen_status = self.generation.status()
            ready = ready and gen_status["ready"]
        since = (None if self.last_predict_mono is None
                 else round(clock.monotonic_s() - self.last_predict_mono, 3))
        status = "ok" if ready else "unready"
        health_status = None
        mon = get_health_monitor()
        if mon is not None:
            health_status = mon.status()
            if ready and health_status["state"] == "degraded":
                status = "degraded"
        return {"status": status,
                "live": True,
                "ready": ready,
                "health": health_status,
                "consecutive_failures": self.consecutive_failures,
                "platform": self.platform,
                "model": self.model_id,
                "inference_mode": str(self._mode),
                "generation": gen_status,
                "seconds_since_last_predict": since}

    def reload(self, path: str) -> None:
        """Hot-swap the served model from a model zip or, given a
        ``CheckpointManager`` directory, from its newest COMPLETE
        checkpoint (dense or sharded); restored without updater state
        onto the server's device."""
        from ..faulttolerance.checkpoint import CheckpointManager
        from ..utils.model_serializer import restore_model
        if os.path.isdir(path):
            mgr = CheckpointManager(path, registry=self.registry)
            newest = mgr.latest_complete()
            if newest is None:
                raise FileNotFoundError(
                    f"no complete checkpoint to promote in {path}")
            new_model, _ = mgr.restore_any(path=newest[1],
                                           load_updater=False,
                                           device=self.device)
        else:
            new_model = restore_model(path, load_updater=False,
                                      device=self.device)
        for_serving(new_model)
        old = self.inference
        self.inference = ParallelInference(new_model, self._mode,
                                           max_batch_size=self._max_batch)
        self.model_id = _model_identity(new_model, origin=path)
        if self.registry.enabled:
            self.registry.counter("inference_model_reloads_total",
                                  "Successful hot model swaps").inc()
        old.shutdown()

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "InferenceServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()
        self.inference.shutdown()


class InferenceClient(JsonClient):
    def predict(self, data) -> np.ndarray:
        return np.asarray(self.post(
            "/predict", {"data": np.asarray(data).tolist()})["output"])

    def metrics_text(self) -> str:
        """Raw Prometheus exposition from the server's /metrics."""
        return self.get_text("/metrics")
