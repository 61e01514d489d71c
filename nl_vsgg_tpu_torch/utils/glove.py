"""GloVe word-vector loading for class-name embeddings (numpy copy of
nl_vsgg_tpu/utils/glove.py, the same rows for the same names and file).

Mirrors the lookup semantics of lib/word_vectors.py:15-35 — try the token's
first '/'-alternative, then fall back to the longest space-separated word —
but with a deterministic seeded fallback instead of the reference's
unseeded-random rows for missing tokens, so init is reproducible without the
800MB GloVe download. When a real `glove.6B.200d.txt` is available
(`glove_path`), vectors match the reference exactly; a .npz cache beside it
avoids re-parsing.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


def _fallback_vector(token: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(token.encode()).digest()[:4], "little")
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def _load_glove_table(path: str) -> dict[str, np.ndarray]:
    cache = path + ".npz"
    if os.path.isfile(cache):
        data = np.load(cache, allow_pickle=True)
        return dict(zip(data["tokens"].tolist(), data["vectors"]))
    table: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        for line in f:
            parts = line.rstrip().split(b" ")
            try:
                word = parts[0].decode("utf-8")
            except UnicodeDecodeError:
                continue
            table[word] = np.asarray([float(x) for x in parts[1:]], dtype=np.float32)
    try:
        np.savez_compressed(cache, tokens=np.array(list(table), dtype=object),
                            vectors=np.stack(list(table.values())))
    except OSError:
        pass
    return table


def obj_edge_vectors(names: list[str] | tuple[str, ...], dim: int = 200,
                     glove_path: str = "") -> np.ndarray:
    """Embedding rows for class names, (len(names), dim) float32."""
    table: dict[str, np.ndarray] = {}
    if glove_path and os.path.isfile(glove_path):
        table = _load_glove_table(glove_path)

    out = np.zeros((len(names), dim), dtype=np.float32)
    for i, token in enumerate(names):
        vec = table.get(token.split("/")[0])
        if vec is None:
            longest = sorted(token.split(" "), key=len, reverse=True)[0]
            vec = table.get(longest)
        out[i] = vec if vec is not None else _fallback_vector(token, dim)
    return out
