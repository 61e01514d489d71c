"""The port's GloVe class-name embeddings against the JAX package's: a small
synthetic vector file written to tmp_path (a '/'-alternative, a
longest-word fallback, a missing token, a line that is not UTF-8), the
.npz cache it leaves, and the seeded fallback rows with no file, all
exactly equal (the same float32 parse, the same seeded draws)."""

import numpy as np

from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.utils import glove as jg
from nl_vsgg_tpu_torch.utils import glove as tg

NAMES = ["person", "cup/glass/bottle", "paper/notebook", "closet/cabinet", "food",
         "sofa/couch", "not a word", "__background__"]


def _write(path, rng, dim):
    words = ["person", "cup", "notebook", "cabinet", "food", "couch", "word", "paper"]
    with open(path, "wb") as f:
        for w in words:
            f.write((w + " " + " ".join(f"{x:.6f}" for x in rng.standard_normal(dim))
                     + "\n").encode())
        f.write(b"\xff\xfe " + b" ".join(b"0.5" for _ in range(dim)) + b"\n")


def test_obj_edge_vectors_from_a_file_and_its_cache(tmp_path):
    dim = 12
    path_t, path_j = tmp_path / "t.txt", tmp_path / "j.txt"
    for p in (path_t, path_j):
        _write(p, np.random.default_rng(0), dim)
    ours = tg.obj_edge_vectors(NAMES, dim, str(path_t))
    ref = jg.obj_edge_vectors(NAMES, dim, str(path_j))
    assert ours.dtype == np.float32 and ours.shape == (len(NAMES), dim)
    np.testing.assert_array_equal(ours, ref)
    assert (tmp_path / "t.txt.npz").exists()
    np.testing.assert_array_equal(tg.obj_edge_vectors(NAMES, dim, str(path_t)), ref)


def test_fallback_vectors_without_a_file(tmp_path):
    classes = list(jschema.load_taxonomy().object_classes)
    missing = str(tmp_path / "missing.txt")
    for names, dim in ((classes, 200), (classes[1:], 200), (NAMES, 7)):
        ref = jg.obj_edge_vectors(names, dim)
        np.testing.assert_array_equal(tg.obj_edge_vectors(names, dim), ref)
        np.testing.assert_array_equal(tg.obj_edge_vectors(names, dim, missing), ref)
