"""Word-embedding visualization helpers (port of ``ui/renders.py``;
reference ``deeplearning4j-ui-parent/deeplearning4j-ui/.../ui/``
word2vec/weights render providers + the t-SNE-CSV workflow the reference
UI's ``/tsne`` page consumes: run t-SNE over the vectors, save
"x,y,label" lines, upload to the server).

``embedding_coords`` reduces vectors to 2-D (the port's exact ``Tsne`` on
the device the caller names, PCA in f64 numpy on the host);
``coords_to_csv_lines`` produces the upload format;
``render_word_scatter`` emits a standalone SVG/HTML report via the
ui-components DSL; ``upload_tsne`` POSTs to a running UIServer.
"""
from __future__ import annotations

from typing import List, Optional, Sequence
from urllib.parse import quote
from urllib.request import Request, urlopen

import numpy as np

from .components import ChartScatter, ComponentText, render_page

__all__ = ["embedding_coords", "coords_to_csv_lines", "render_word_scatter",
           "upload_tsne"]


def embedding_coords(vectors, method: str = "pca", seed: int = 0,
                     perplexity: float = 15.0, max_iter: int = 300,
                     device="cuda") -> np.ndarray:
    """Reduce [N,D] vectors to [N,2] coordinates.  ``method`` = 'pca' | 'tsne'
    (reference workflow uses BarnesHutTsne, ``plot/BarnesHutTsne.java``);
    ``device`` is where t-SNE runs (PCA runs on the host)."""
    v = np.asarray(vectors, dtype=np.float64)
    if method == "tsne":
        from ..clustering import Tsne
        return np.asarray(Tsne(perplexity=min(perplexity, max(2.0, (len(v) - 1) / 3.0)),
                               max_iter=max_iter, seed=seed,
                               device=device).fit(v))
    v = v - v.mean(axis=0, keepdims=True)
    # PCA via SVD: top-2 right singular vectors
    _, _, vt = np.linalg.svd(v, full_matrices=False)
    return v @ vt[:2].T


def coords_to_csv_lines(coords, labels: Optional[Sequence[str]] = None) -> List[str]:
    """"x,y,label" lines — the format the /tsne endpoints store and plot.
    Labels are sanitized (commas/newlines would corrupt the line format the
    scatter page splits on)."""
    coords = np.asarray(coords)
    out = []
    for i, (x, y) in enumerate(coords[:, :2]):
        label = str(labels[i]) if labels is not None else ""
        label = label.replace(",", ";").replace("\n", " ").replace("\r", " ")
        out.append(f"{float(x):.6g},{float(y):.6g},{label}")
    return out


def render_word_scatter(word_vectors, words: Optional[Sequence[str]] = None,
                        method: str = "pca", title: str = "Word embeddings",
                        path: Optional[str] = None, device="cuda") -> str:
    """Standalone HTML scatter of a model's word embeddings.  ``word_vectors``
    is any model exposing the WordVectors API (vocab + lookup_table);
    ``device`` is where t-SNE runs."""
    vocab_words = list(words) if words is not None else \
        list(word_vectors.vocab.words())
    vecs = np.stack([word_vectors.get_word_vector(w) for w in vocab_words])
    coords = embedding_coords(vecs, method=method, device=device)
    chart = ChartScatter(title)
    chart.add_series("words", coords[:, 0], coords[:, 1])
    html = render_page(
        [ComponentText(f"{len(vocab_words)} words, method={method}"), chart],
        title=title)
    if path is not None:
        with open(path, "w") as f:
            f.write(html)
    return html


def upload_tsne(url: str, coords, labels: Optional[Sequence[str]] = None,
                session_id: Optional[str] = None, timeout: float = 5.0) -> None:
    """POST coordinates to a running UIServer's /tsne module."""
    lines = coords_to_csv_lines(coords, labels)
    endpoint = (url.rstrip("/") +
                ("/tsne/post/" + quote(session_id, safe="")
                 if session_id else "/tsne/upload"))
    req = Request(endpoint, data="\n".join(lines).encode(),
                  headers={"Content-Type": "text/plain"})
    with urlopen(req, timeout=timeout) as resp:
        resp.read()
