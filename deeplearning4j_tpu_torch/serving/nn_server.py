"""Nearest-neighbors REST server + client (port of
``serving/nn_server.py``: reference
``deeplearning4j-nearestneighbor-server/.../NearestNeighborsServer.java:44``
and ``client/NearestNeighborsClient.java``).

The index is pluggable: ``BruteForceNN`` (the distance product and top-k
on the card, the default) or ``VPTree`` (host metric tree, the
reference's structure).  Brute-force queries run on one worker thread of
the server, so handler threads hand over and get back host arrays only.

Endpoints (reference routes):
  POST /knn      {"ndarray": [...], "k": n}          query by raw vector
  POST /knnindex {"index": i, "k": n}                query by stored row index
  GET  /health   liveness + readiness (platform, index identity,
                 seconds since the last successful query)
  GET  /metrics  Prometheus text exposition (?format=json for a snapshot)
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..clustering.neighbors import BruteForceNN, VPTree
from ..observability import clock
from ..observability.registry import default_registry
from ..utils.http import BackgroundHttpServer, JsonClient, JsonHandler
from ..utils.profiling import device_platform

__all__ = ["NearestNeighborsServer", "NearestNeighborsClient"]

# seconds a handler waits for its query on the device worker
_QUERY_TIMEOUT_S = 60.0


class _NNHandler(JsonHandler):
    server_ref = None  # type: NearestNeighborsServer

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
        try:
            body = self._read_json()
        except Exception as e:
            return self._json({"error": f"bad json: {e}"}, 400)
        srv = self.server_ref
        route = self.path.rstrip("/")
        try:
            k = int(body.get("k", 1))
            if route == "/knn":
                vec = np.asarray(body["ndarray"], dtype=np.float32)
                dist, idx = srv.query(vec, k)
            elif route == "/knnindex":
                i = int(body["index"])
                if not 0 <= i < len(srv.points):
                    return self._json({"error": f"index {i} out of range"},
                                      400)
                # k+1 then drop self (reference knn-by-index semantics)
                dist, idx = srv.query(srv.points[i], k + 1)
                keep = idx != i
                dist, idx = dist[keep][:k], idx[keep][:k]
            else:
                return self._json({"error": "not found"}, 404)
        except KeyError as e:
            return self._json({"error": f"missing field {e}"}, 400)
        except Exception as e:  # ragged vectors, k > N, ... -> client error
            return self._json({"error": str(e)}, 400)
        srv.last_query_mono = clock.monotonic_s()
        return self._json({"results": [
            {"index": int(i), "distance": float(d)}
            for d, i in zip(dist, idx)]})


class NearestNeighborsServer:
    """Serve kNN over a points matrix [N,D]; ``index="brute"`` keeps the
    points on ``device``."""

    def __init__(self, points, port: int = 0, index: str = "brute",
                 metric: str = "euclidean", registry=None, device="cuda"):
        self.points = np.asarray(points, dtype=np.float32)
        self.index_kind = index
        self._worker: Optional[ThreadPoolExecutor] = None
        if index == "brute":
            self._index = BruteForceNN(self.points, metric=metric,
                                       device=device)
            self.platform = device_platform(self._index.device)
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dl4j-torch-knn")
        elif index == "vptree":
            self._index = VPTree(self.points, metric=metric)
            self.platform = "cpu"
        else:
            raise ValueError(f"unknown index '{index}' (brute|vptree)")
        self.registry = registry if registry is not None \
            else default_registry()
        self.last_query_mono: Optional[float] = None
        self._server = BackgroundHttpServer(_NNHandler, port, server_ref=self,
                                            metrics_registry=self.registry)

    def query(self, vec, k: int):
        """(distances [k], indices [k]) of one query vector, nearest
        first."""
        if self._worker is None:
            return self._index.query(vec, k)
        dist, idx = self._worker.submit(
            self._index.query, np.asarray(vec)[None], k).result(
                timeout=_QUERY_TIMEOUT_S)
        return dist[0], idx[0]

    def health(self) -> dict:
        """Liveness vs readiness; ``status``/``points`` keys stay for
        older probes."""
        ready = len(self.points) > 0
        since = (None if self.last_query_mono is None
                 else round(clock.monotonic_s() - self.last_query_mono, 3))
        d = self.points.shape[1] if self.points.ndim == 2 else 0
        return {"status": "ok" if ready else "unready",
                "live": True,
                "ready": ready,
                "platform": self.platform,
                "model": f"knn[{self.index_kind},n={len(self.points)},"
                         f"d={d}]",
                "points": len(self.points),
                "seconds_since_last_query": since}

    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "NearestNeighborsServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()
        if self._worker is not None:
            self._worker.shutdown(wait=True)


class NearestNeighborsClient(JsonClient):
    """HTTP client (reference ``NearestNeighborsClient.java``)."""

    def __init__(self, url: str, timeout: float = 5.0):
        super().__init__(url, timeout)

    def knn(self, vector, k: int = 1) -> list:
        return self.post("/knn", {"ndarray": np.asarray(vector).tolist(),
                                  "k": k})["results"]

    def knn_by_index(self, index: int, k: int = 1) -> list:
        return self.post("/knnindex", {"index": index, "k": k})["results"]
