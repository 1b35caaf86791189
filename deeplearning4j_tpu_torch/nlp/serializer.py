"""WordVectorSerializer: persistence formats for embedding models (port of
``nlp/serializer.py``: the same bytes, so each package reads the other's
files).

Reference ``models/embeddings/loader/WordVectorSerializer.java`` (txt, csv,
the original word2vec C binary format, gzipped variants, and a zip "full
model" with vocab + weights + config).  Formats kept wire-compatible with
the ecosystem:

- ``write_word_vectors`` / ``read_word_vectors``: the gensim/word2vec .txt
  format — header line ``<vocab> <dim>``, then ``word v1 v2 ...`` rows.
- ``write_csv`` / ``read_csv``: headerless ``word,v1,v2,...`` rows.
- ``write_binary`` / ``read_binary``: word2vec C ``.bin`` (little-endian f32).
- ``write_full_model`` / ``read_full_model``: zip of config.json +
  vocab.json + syn0/syn1/syn1neg .npy — lossless round-trip incl. Huffman
  codes and counts, so training can resume.
- gzip: text formats write compressed when the path ends in ``.gz`` and
  reads auto-detect the gzip magic (the reference reads compressed models
  transparently).
- ``load_static_model``: sniff the format (zip / gzip / binary / csv /
  txt) and load vectors for inference — the ``loadStaticModel`` role.

The readers place the tables on ``device`` ("cuda" by default; they raise
without a card unless asked for ``"cpu"``).
"""
from __future__ import annotations

import gzip
import io
import json
import zipfile

import numpy as np
import torch

from .lookup_table import InMemoryLookupTable
from .sequence_vectors import SequenceVectors
from .vocab import VocabCache, VocabWord
from .word2vec import Word2Vec


def _open_text_write(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "wt", encoding="utf-8")
    return open(path, "w", encoding="utf-8")


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _open_text_read(path: str):
    if _is_gzip(path):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_word_vectors(model, path: str) -> None:
    syn0 = _host(model.lookup_table.syn0)
    with _open_text_write(path) as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
        for i in range(syn0.shape[0]):
            vec = " ".join(f"{x:.6f}" for x in syn0[i])
            f.write(f"{model.vocab.word_at_index(i)} {vec}\n")


def read_word_vectors(path: str, device="cuda") -> Word2Vec:
    with _open_text_read(path) as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        vocab = VocabCache()
        rows = np.zeros((n, d), dtype=np.float32)
        for i in range(n):
            parts = f.readline().rstrip("\n").split(" ")
            vocab.add_token(VocabWord(parts[0]))
            rows[i] = [float(x) for x in parts[1:d + 1]]
    return _assemble(vocab, rows, device)


def write_csv(model, path: str) -> None:
    """Headerless csv rows ``word,v1,...`` (reference WordVectorSerializer
    csv flavor).  Commas in words are not representable — rejected."""
    syn0 = _host(model.lookup_table.syn0)
    with _open_text_write(path) as f:
        for i in range(syn0.shape[0]):
            word = model.vocab.word_at_index(i)
            if "," in word:
                raise ValueError(
                    f"word {word!r} contains a comma — csv cannot carry it; "
                    "use the txt or binary format")
            f.write(word + "," + ",".join(f"{x:.6f}" for x in syn0[i]) + "\n")


def read_csv(path: str, device="cuda") -> Word2Vec:
    vocab = VocabCache()
    rows = []
    with _open_text_read(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(",")
            vocab.add_token(VocabWord(parts[0]))
            rows.append([float(x) for x in parts[1:]])
    return _assemble(vocab, np.asarray(rows, dtype=np.float32), device)


def write_binary(model, path: str) -> None:
    syn0 = _host(model.lookup_table.syn0).astype(np.float32)
    with open(path, "wb") as f:
        f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n".encode())
        for i in range(syn0.shape[0]):
            f.write(model.vocab.word_at_index(i).encode() + b" ")
            f.write(syn0[i].tobytes())
            f.write(b"\n")


def read_binary(path: str, device="cuda") -> Word2Vec:
    with open(path, "rb") as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        vocab = VocabCache()
        rows = np.zeros((n, d), dtype=np.float32)
        for i in range(n):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch in (b" ", b""):
                    break
                word.extend(ch)
            rows[i] = np.frombuffer(f.read(4 * d), dtype="<f4")
            f.read(1)  # trailing newline
            vocab.add_token(VocabWord(word.decode()))
    return _assemble(vocab, rows, device)


def _assemble(vocab: VocabCache, rows: np.ndarray, device) -> Word2Vec:
    model = Word2Vec(sentences=[], layer_size=rows.shape[1], device=device)
    model.vocab = vocab
    model.lookup_table = InMemoryLookupTable(vocab, rows.shape[1],
                                             device=model.device)
    model.lookup_table.syn0 = torch.from_numpy(rows).to(model.device)
    return model


def _sniffed_row_is_text(chunk: bytes):
    """True when the sniffed first data row parses as ``word v1 v2 ...`` —
    packed float32 bytes can happen to decode as UTF-8, so decodability
    alone must not route to the txt reader.  Float-parsability (not token
    count) is the discriminator: a slightly nonconforming real txt file
    (extra column, missing trailing newline) still routes to the txt reader
    so its errors surface there, instead of read_binary silently loading
    ASCII digits as packed f32 garbage.

    Returns ``None`` (inconclusive) when the window holds no newline and
    only one value token whose float-parse fails: the token may be cut
    mid-value (``1e``, ``-``), which says nothing about the format — the
    caller should widen the window rather than route to read_binary."""
    line, sep, _ = chunk.partition(b"\n")
    toks = line.decode("utf-8", errors="replace").split()
    if len(toks) < 2:
        return False
    # truncated row (no newline in the window): the last token may be cut
    # mid-value — a float prefix still parses, raw f32 bytes don't
    vals = toks[1:] if sep else (toks[1:-1] or [toks[-1]])
    try:
        for v in vals:
            float(v)
    except ValueError:
        return None if not sep and len(toks) == 2 else False
    return True


def load_static_model(path: str, device="cuda") -> Word2Vec:
    """Load vectors from any supported on-disk format for inference
    (reference ``WordVectorSerializer.loadStaticModel``): sniffs zip (full
    model), gzip (txt/csv inside), word2vec C binary, csv, and txt.
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic[:2] == b"PK":
        return read_full_model(path, device)
    if magic[:2] == b"\x1f\x8b":
        with gzip.open(path, "rt", encoding="utf-8") as f:
            first = f.readline()
        return (read_csv(path, device) if "," in first
                else read_word_vectors(path, device))
    # uncompressed: header "n d" means txt/bin; csv has no header
    with open(path, "rb") as f:
        first = f.readline()
    try:
        text = first.decode("utf-8").strip()
    except UnicodeDecodeError:
        text = ""
    parts = text.split()
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        # txt and bin share the header; bin rows are raw little-endian f32
        # after "word " — sniff the second line for utf-8 text
        for window in (256, 4096, 1 << 20):
            with open(path, "rb") as f:
                f.readline()
                second = f.read(window)
            try:
                second.decode("utf-8")
                looks_text = True
            except UnicodeDecodeError as e:
                # a multi-byte character split at the chunk boundary is
                # still text; only an interior decode failure means binary
                looks_text = e.start >= len(second) - 4
            if not looks_text:
                return read_binary(path, device)
            verdict = _sniffed_row_is_text(second)
            if verdict is None and len(second) == window:
                continue          # truncated mid-value: widen the sniff
            # an inconclusive row that IS the whole file routes to the txt
            # reader so its parse error surfaces there (see docstring)
            return (read_word_vectors(path, device) if verdict is not False
                    else read_binary(path, device))
        return read_binary(path, device)
    if "," in text:
        return read_csv(path, device)
    raise ValueError(f"unrecognized word-vector format in {path!r}")


def write_full_model(model: SequenceVectors, path: str) -> None:
    lt = model.lookup_table
    config = {
        "layer_size": model.layer_size, "window": model.window,
        "learning_rate": model.learning_rate,
        "min_learning_rate": model.min_learning_rate,
        "negative": model.negative, "use_hs": model.use_hs,
        "sampling": model.sampling,
        "min_word_frequency": model.min_word_frequency,
        "epochs": model.epochs, "batch_size": model.batch_size,
        "seed": model.seed, "elements_algorithm": model.elements_algorithm,
        "total_word_count": model.vocab.total_word_count,
    }
    vocab_rows = [{"word": vw.word, "count": vw.count, "codes": vw.codes,
                   "points": vw.points, "is_label": vw.is_label}
                  for vw in model.vocab.vocab_words()]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("config.json", json.dumps(config))
        z.writestr("vocab.json", json.dumps(vocab_rows))
        for name in ("syn0", "syn1", "syn1neg"):
            arr = getattr(lt, name)
            if arr is not None:
                buf = io.BytesIO()
                np.save(buf, _host(arr))
                z.writestr(f"{name}.npy", buf.getvalue())


def read_full_model(path: str, device="cuda") -> Word2Vec:
    with zipfile.ZipFile(path) as z:
        config = json.loads(z.read("config.json"))
        vocab_rows = json.loads(z.read("vocab.json"))
        arrays = {}
        for name in ("syn0", "syn1", "syn1neg"):
            try:
                arrays[name] = np.load(io.BytesIO(z.read(f"{name}.npy")))
            except KeyError:
                arrays[name] = None
    total = config.pop("total_word_count", 0)
    use_hs = config.pop("use_hs")
    config["use_hierarchic_softmax"] = use_hs
    model = Word2Vec(sentences=[], device=device, **config)
    vocab = VocabCache()
    for row in vocab_rows:
        vw = VocabWord(row["word"], count=row["count"],
                       is_label=row.get("is_label", False))
        vw.codes, vw.points = row["codes"], row["points"]
        vocab.add_token(vw)
    vocab.total_word_count = total
    model.vocab = vocab
    lt = InMemoryLookupTable(vocab, config["layer_size"],
                             seed=config["seed"], use_hs=use_hs,
                             negative=config["negative"], device=model.device)
    lt.syn0 = torch.from_numpy(arrays["syn0"]).to(model.device)
    if arrays["syn1"] is not None:
        lt.syn1 = torch.from_numpy(arrays["syn1"]).to(model.device)
    if arrays["syn1neg"] is not None:
        lt.syn1neg = torch.from_numpy(arrays["syn1neg"]).to(model.device)
        from .vocab import make_unigram_table
        lt.table = make_unigram_table(vocab)
    model.lookup_table = lt
    return model
