"""The port's host data engine against the JAX package, part 1: the schema
maps, the numpy union masks, the native reader and packer, the Action Genome
readers, grounding on the python and the native path, and the union cache.

Everything here is host numpy or integer work, so the comparisons are
exact (no tolerance), except the numpy union masks against the port's
torch rasterizer (1e-6: the same float32 closed form, another library).
Inputs are seeded numpy and `tests.fixtures.build_micro_ag`.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from nl_vsgg_tpu.data import grounding as jgr
from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.data.action_genome import AGTest as JAGTest
from nl_vsgg_tpu.data.action_genome import AGTrain as JAGTrain
from nl_vsgg_tpu.ops.union_masks import draw_union_boxes_np as j_draw_np
from nl_vsgg_tpu.utils import native_io as jnative
from nl_vsgg_tpu_torch.data import grounding as gr
from nl_vsgg_tpu_torch.data import schema
from nl_vsgg_tpu_torch.data.action_genome import AGTest, AGTrain, maybe_download
from nl_vsgg_tpu_torch.data.entry import Entry
from nl_vsgg_tpu_torch.ops.union_masks import draw_union_boxes, draw_union_boxes_np
from nl_vsgg_tpu_torch.utils import native_io
from tests.fixtures import build_micro_ag

FEAT = 16
LADDER = ((8, 16, 32, 64), (8, 16, 32, 64))


def assert_same_entry(ours: Entry | None, ref, valid_rows_only: bool = False):
    """Every field of the port's Entry equals the JAX Entry's, dtype, shape
    and bits. `valid_rows_only` compares the relation-side fields on
    rel_mask rows (pad_entry keeps junk on clamp-killed rows where the
    native engine writes zeros; both are masked everywhere)."""
    assert (ours is None) == (ref is None)
    if ours is None:
        return
    rm = np.asarray(ref.rel_mask)
    for f in dataclasses.fields(Entry):
        a, b = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, (f.name, a.dtype, b.dtype)
        if valid_rows_only and f.name in ("spatial_masks", "pair_idx", "im_idx",
                                          "attention_gt", "spatial_gt", "contacting_gt"):
            a, b = a[rm], b[rm]
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# ------------------------------------------------------------------ schema
def test_schema_maps_match_jax():
    ours, ref = schema.load_oi_ag_maps(), jschema.load_oi_ag_maps()
    assert ours[0] == ref[0] and ours[1] == ref[1]
    np.testing.assert_array_equal(schema.oi_to_ag_matrix(), jschema.oi_to_ag_matrix())
    m = schema.oi_to_ag_matrix()
    assert m.shape == (1595, 37) and np.array_equal(m[1594], m[1593])
    assert schema.person_oi_ids() == jschema.person_oi_ids()


# ------------------------------------------------------------- union masks
@pytest.mark.parametrize("as_nchw", [False, True])
def test_draw_union_boxes_np_matches(as_nchw):
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 400, (3, 20, 2, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 200, (3, 20, 2, 2))], -1)
    rois = boxes.reshape(3, 20, 8).astype(np.float32)
    rois[0, :3] = 0.0                                # degenerate padded pairs
    ours = draw_union_boxes_np(rois, 27, as_nchw)
    np.testing.assert_array_equal(ours, j_draw_np(rois, 27, as_nchw))
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    dev = draw_union_boxes(torch.from_numpy(rois), 27, as_nchw).numpy()
    np.testing.assert_allclose(ours, dev, atol=1e-6, rtol=0)


# ------------------------------------------------------- native reader/packer
@pytest.fixture(params=["native", "numpy"])
def io_mode(request, monkeypatch):
    """Both packages on their native library, or both on the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(native_io, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert native_io.get_lib() is not None and jnative.get_lib() is not None
    return request.param


def test_native_library_builds_into_build_dir():
    native_io.get_lib()
    path = native_io.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native_io.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "torch_native"


def test_read_feat_batch_and_pack_padded_match(tmp_path, io_mode):
    rng = np.random.default_rng(1)
    paths = []
    for i, rows in enumerate((3, 2, 7, 5, 0)):
        p = str(tmp_path / f"f{i}.npy")
        np.save(p, rng.standard_normal((rows, 12)).astype(np.float32))
        paths.append(p)
    # a frame with no detection (0 rows): the port reads it on both paths,
    # where the JAX package's numpy fallback raises on the reshape
    empty, counts = native_io.read_feat_batch(paths[4:], 12, 8)
    assert counts.tolist() == [0] and not empty.any()
    paths = paths[:4]
    ours, ref = native_io.read_feat_batch(paths, 12, 8), jnative.read_feat_batch(paths, 12, 8)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # rows past max_rows_each are dropped, with the same warning
    with pytest.warns(UserWarning, match="exceed max_rows=4"):
        ours = native_io.read_feat_batch(paths, 12, 4)
    with pytest.warns(UserWarning, match="exceed max_rows=4"):
        ref = jnative.read_feat_batch(paths, 12, 4)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[1], [3, 2, 4, 4])

    src = rng.standard_normal((15, 6)).astype(np.float32)
    counts = np.array([4, 0, 9, 2])
    np.testing.assert_array_equal(native_io.pack_padded(src, counts, 5),
                                  jnative.pack_padded(src, counts, 5))


def test_pyset_intersect_order_matches_cpython():
    rng = np.random.default_rng(2)
    for _ in range(500):
        hi = int(rng.choice([8, 37, 200, 10 ** 6]))
        a = rng.integers(0, hi, int(rng.integers(0, 8))).tolist()
        b = rng.integers(0, hi, int(rng.integers(0, 40))).tolist()
        assert native_io.pyset_intersect_order(a, b) == list(set(tuple(a)) & set(frozenset(b)))


# ------------------------------------------------------------------ readers
def _quirk_ag(root: str) -> str:
    """A micro AG whose test split has a 1-frame, a 2-frame and a 0-frame
    video and frames without a person box, and whose train split has a
    1-frame video and a video missing from the frame lists."""
    ag = build_micro_ag(root, n_videos=5, n_frames=4, feat_dim=FEAT, n_objs=2)
    ann = os.path.join(ag, "annotations")
    with open(os.path.join(ann, "person_bbox.pkl"), "rb") as f:
        person = pickle.load(f)
    for key in list(person):
        vid, fr = key.split("/")
        frame = int(fr.split(".")[0])
        if (vid == "vid001.mp4" and frame >= 1) or (vid == "vid002.mp4" and frame >= 2) \
                or vid == "vid003.mp4" or (vid == "vid004.mp4" and frame == 1):
            person[key] = dict(person[key], bbox=np.zeros((0, 4), np.float32))
    with open(os.path.join(ann, "person_bbox.pkl"), "wb") as f:
        pickle.dump(person, f)
    with open(os.path.join(ag, "triplets_LLM4SGG.pkl"), "rb") as f:
        lists = pickle.load(f)
    lists["vid001.mp4"]["frame_list"] = lists["vid001.mp4"]["frame_list"][:1]
    del lists["vid002.mp4"]
    with open(os.path.join(ag, "triplets_LLM4SGG.pkl"), "wb") as f:
        pickle.dump(lists, f)
    return ag


def _same_tree(a, b, path="") -> None:
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("remove_one", [True, False])
def test_agtrain_matches_jax(tmp_path, remove_one):
    ag = _quirk_ag(str(tmp_path))
    ours = AGTrain(ag, remove_one_frame_video=remove_one)
    ref = JAGTrain(ag, remove_one_frame_video=remove_one)
    assert ours.video_ids == ref.video_ids
    assert ("vid001.mp4" in ours.video_ids) is not remove_one
    assert "vid002.mp4" not in ours.video_ids                # no frame list
    for name in ("video_list", "gt_annotations", "img_info", "triplet_count", "total_frames",
                 "action_count", "object_classes", "relationship_classes"):
        _same_tree(getattr(ours, name), getattr(ref, name), name)
    assert list(ours) == list(ref) and len(ours) == len(ref)


def test_agtest_matches_jax_with_two_frame_quirk(tmp_path):
    ag = _quirk_ag(str(tmp_path))
    ann = os.path.join(ag, "annotations")
    ours, ref = AGTest(ann), JAGTest(ann)
    assert ours.video_ids == ref.video_ids == ["vid000.mp4", "vid004.mp4"]
    # vid001 keeps 1 frame; vid002 keeps 2 and lands in the "non person"
    # tally with vid003 (0 frames), the reference's counter quirk
    assert (ours.one_frame_video, ours.non_person_video) == (1, 2)
    for name in ("video_list", "video_size", "img_info", "gt_annotations", "non_gt_human_nums",
                 "non_person_video", "one_frame_video", "valid_nums"):
        _same_tree(getattr(ours, name), getattr(ref, name), name)


def test_maybe_download_semantics(tmp_path):
    dest = str(tmp_path / "sub" / "a.pkl")
    got = []
    maybe_download(dest, "a.pkl", enabled=False, fetch_fn=lambda u, p: got.append(u))
    assert not got and not os.path.exists(dest)

    def fetch(url, path):
        got.append(url)
        with open(path, "wb") as f:
            f.write(b"x")
    maybe_download(dest, "a.pkl", enabled=True, fetch_fn=fetch)
    assert got == ["https://huggingface.co/datasets/kb-kim/NL-VSGG/resolve/main/a.pkl"]
    assert open(dest, "rb").read() == b"x"
    maybe_download(dest, "a.pkl", enabled=True, fetch_fn=fetch)   # present: no fetch
    assert len(got) == 1


# ---------------------------------------------------------------- grounding
def _fuzz_video(root: str, rng, n_frames: int, seed: int):
    """Frame dirs (dets.npy, the dets_f32.npy sidecar, feat.npy) and a GT
    annotation that stress the set-order quirk (multi-mapped OI classes),
    the 1594 -> 1593 fold, duplicate and unmapped classes, frames without a
    person, empty frames and GT classes no detection has."""
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
    person_ids = sorted(ag_to_oi[1])
    single = [k for k, v in oi_to_ag.items() if len(v) == 1 and k not in set(person_ids)]
    multi = [k for k, v in oi_to_ag.items() if len(v) > 1]
    unmapped = [k for k in range(1594) if not oi_to_ag.get(k)]
    paths, gt = [], []
    for f in range(n_frames):
        d = os.path.join(root, f"v{seed}", f"f{f}.png")
        os.makedirs(d, exist_ok=True)
        nd = int(rng.integers(0, 8))
        cls = [int(rng.choice(person_ids))] if rng.random() < 0.8 and nd else []
        while len(cls) < nd:
            r = rng.random()
            if r < 0.35:
                cls.append(int(rng.choice(multi)))
            elif r < 0.8:
                cls.append(int(rng.choice(single)))
            elif r < 0.9:
                cls.append(int(rng.choice(unmapped)))
            elif r < 0.95:
                cls.append(1594)                      # folds to 1593
            else:
                cls.append(int(rng.choice(person_ids)))  # an extra person
        rng.shuffle(cls)
        dets = [{"class": c, "conf": np.float32(rng.random()),
                 "rect": rng.uniform(0, 500, 4).astype(np.float32)} for c in cls]
        np.save(os.path.join(d, "dets.npy"), np.asarray(dets, object), allow_pickle=True)
        np.save(os.path.join(d, gr.DETS_F32), gr.dets_to_f32(dets))
        np.save(os.path.join(d, "feat.npy"),
                rng.standard_normal((len(cls), FEAT)).astype(np.float32))
        paths.append(d)
        mapped = [a for c in cls for a in oi_to_ag.get(1593 if c == 1594 else c, [])]
        chosen = {int(c) for c in mapped if rng.random() < 0.7}
        chosen |= {int(rng.integers(2, 37)) for _ in range(rng.integers(0, 2))}
        frame_gt = [{"person_bbox": np.zeros(4, np.float32)}]
        for c in sorted(chosen, key=lambda _: rng.random()):
            frame_gt.append({
                "class": c,
                "attention_relationship": rng.choice(3, rng.integers(1, 3), replace=False),
                "spatial_relationship": rng.choice(6, rng.integers(1, 3), replace=False),
                "contacting_relationship": rng.choice(17, rng.integers(1, 4), replace=False)})
        gt.append(frame_gt)
    return paths, gt


def _union_fn(f, boxes):
    """A deterministic numpy union-feature provider."""
    b = np.asarray(boxes, np.float32)
    base = (b.sum(1) / 1000.0 + f)[:, None, None, None]
    return (base + np.arange(FEAT, dtype=np.float32) / FEAT) * np.ones((1, 7, 7, 1), np.float32)


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("union", [False, True])
def test_wk_forward_matches_jax(tmp_path, is_train, masks, union):
    rng = np.random.default_rng(10 + 2 * is_train + masks)
    n = 0
    for seed in range(6):
        paths, gt = _fuzz_video(str(tmp_path), rng, int(rng.integers(2, 6)), seed)
        frames = gr.load_frame_features(paths, use_native=False, feat_dim=FEAT)
        jframes = jgr.load_frame_features(paths, use_native=False, feat_dim=FEAT)
        for a, b in zip(frames, jframes):
            for k in ("classes", "confs", "rects", "feats"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        kw = dict(feat_dim=FEAT, compute_spatial_masks=masks,
                  union_feat_fn=_union_fn if union else None)
        drops, jdrops = [], []
        ours = gr.wk_forward(frames, gt, is_train, *LADDER, **kw,
                             on_truncate=lambda b, r: drops.append((b, r)))
        ref = jgr.wk_forward(jframes, gt, is_train, *LADDER, **kw,
                             on_truncate=lambda b, r: jdrops.append((b, r)))
        assert drops == jdrops
        assert_same_entry(ours, ref)
        n += ours is not None
    assert n >= 3


def test_grounded_frames_match_jax(tmp_path):
    """assign_labels_frame (the loop) and assign_labels_frame_fast agree
    with each other and with the JAX functions, frame by frame."""
    rng = np.random.default_rng(5)
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
    person = frozenset(ag_to_oi[1])
    for seed in range(4):
        paths, gt = _fuzz_video(str(tmp_path), rng, 5, seed)
        for fr, g in zip(gr.load_frame_features(paths, use_native=False, feat_dim=FEAT), gt):
            for is_train in (True, False):
                got = [fn(fr, g, is_train, person, oi_to_ag)
                       for fn in (gr.assign_labels_frame, gr.assign_labels_frame_fast,
                                  jgr.assign_labels_frame_fast)]
                for other in got[1:]:
                    assert other.has_person == got[0].has_person
                    if got[0].has_person:
                        for k in ("obj_classes", "obj_confs", "obj_rects", "obj_feats"):
                            np.testing.assert_array_equal(getattr(other, k), getattr(got[0], k))
    np.testing.assert_array_equal(gr.create_dis(np.float32([0.3, 0.9]), [0, 35]),
                                  jgr.create_dis(np.float32([0.3, 0.9]), [0, 35]))


@pytest.mark.parametrize("is_train", [True, False])
def test_wk_forward_native_matches_both_python_paths(tmp_path, is_train):
    rng = np.random.default_rng(42 + is_train)
    n_strict = 0
    for seed in range(12):
        paths, gt = _fuzz_video(str(tmp_path), rng, int(rng.integers(1, 7)), seed)
        frames = gr.load_frame_features(paths, use_native=True, feat_dim=FEAT)
        drops = []
        py = gr.wk_forward(frames, gt, is_train, *LADDER, feat_dim=FEAT,
                           compute_spatial_masks=True,
                           on_truncate=lambda b, r: drops.append((b, r)))
        jpy = jgr.wk_forward(jgr.load_frame_features(paths, use_native=True, feat_dim=FEAT),
                             gt, is_train, *LADDER, feat_dim=FEAT, compute_spatial_masks=True)
        nat = gr.wk_forward_native(paths, gt, is_train, *LADDER, feat_dim=FEAT,
                                   compute_spatial_masks=True)
        assert nat is not gr._NATIVE_UNAVAILABLE
        assert_same_entry(py, jpy)
        assert_same_entry(nat, jpy, valid_rows_only=bool(drops))
        if nat is not None and not drops:
            n_strict += 1
            assert not nat.spatial_masks[~nat.rel_mask].any()
    assert n_strict >= 3


def test_native_truncation_counts_and_gt_pack_reuse(tmp_path):
    rng = np.random.default_rng(7)
    paths, gt = _fuzz_video(str(tmp_path), rng, 6, 99)
    frames = gr.load_frame_features(paths, use_native=True, feat_dim=FEAT)
    py, nat, jnat = [], [], []
    gr.wk_forward(frames, gt, True, 2, 2, feat_dim=FEAT,
                  on_truncate=lambda b, r: py.append((b, r)))
    e = gr.wk_forward_native(paths, gt, True, (2,), (2,), feat_dim=FEAT,
                             on_truncate=lambda b, r: nat.append((b, r)))
    je = jgr.wk_forward_native(paths, gt, True, (2,), (2,), feat_dim=FEAT,
                               on_truncate=lambda b, r: jnat.append((b, r)))
    assert py == nat == jnat and nat
    assert_same_entry(e, je)
    pack = gr.pack_gt_annotation(gt)
    jpack = jgr.pack_gt_annotation(gt)
    for k in ("cls", "off", "att", "sp", "con"):
        np.testing.assert_array_equal(getattr(pack, k), getattr(jpack, k))
    a = gr.wk_forward_native(paths, gt, True, (32,), (32,), feat_dim=FEAT)
    b = gr.wk_forward_native(paths, gt, True, (32,), (32,), feat_dim=FEAT, gt_pack=pack)
    assert_same_entry(a, jgr.wk_forward_native(paths, gt, True, (32,), (32,), feat_dim=FEAT))
    for f in dataclasses.fields(Entry):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    # eval mode needs no GT arrays; missing sidecars fall back to python
    c = gr.wk_forward_native(paths, None, False, (32,), (32,), feat_dim=FEAT)
    assert c is None or c.spatial_masks.shape[-1] == 0
    os.remove(os.path.join(paths[0], gr.DETS_F32))
    assert gr.wk_forward_native(paths, gt, True, (32,), (32,), feat_dim=FEAT) \
        is gr._NATIVE_UNAVAILABLE


def test_entries_share_numpy_memory_and_pass_bucket_zeros_through(tmp_path):
    """No provider: the union block is one bucket-sized zeros array that
    pad_entry passes through as a view (no 38 MB copy a video at full
    width); the Entry is CPU tensors."""
    rng = np.random.default_rng(3)
    paths, gt = _fuzz_video(str(tmp_path), rng, 4, 1)
    seen = []
    orig = gr._resolve_union_features

    def spy(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]
    gr._resolve_union_features = spy
    try:
        frames = gr.load_frame_features(paths, use_native=False, feat_dim=FEAT)
        e = gr.wk_forward(frames, gt, True, 64, 64, feat_dim=FEAT)
    finally:
        gr._resolve_union_features = orig
    assert e is not None and e.union_feat.device.type == "cpu"
    assert e.union_feat.data_ptr() == seen[0].ctypes.data


# -------------------------------------------------------------- union cache
def _union_case(tmp_path, seed=4):
    rng = np.random.default_rng(seed)
    union = rng.uniform(0, 300, (5, 4)).astype(np.float32)
    im = np.array([0, 0, 1, 2, 2])
    return union, im, str(tmp_path / "uc" / "v.npz")


def _resolve(mod, union, im, path, fn, key="k", dtype="float32"):
    return mod._resolve_union_features(union, im, 8, FEAT, fn, path, dtype, key)


def test_union_cache_hit_stale_torn_and_failed_provider(tmp_path):
    union, im, path = _union_case(tmp_path)
    calls = []

    def fn(f, boxes):
        calls.append(f)
        return _union_fn(f, boxes)
    first = _resolve(gr, union, im, path, fn)
    assert calls == [0, 1, 2] and os.path.isfile(path)
    np.testing.assert_array_equal(first, jgr._resolve_union_features(
        union, im, 8, FEAT, _union_fn, None, "float32", "k"))
    # a hit: nothing extracted, the same array (the JAX package reads the
    # port's file as a hit too)
    again = _resolve(gr, union, im, path, fn)
    assert calls == [0, 1, 2]
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(
        _resolve(jgr, union, im, path, lambda *a: pytest.fail("JAX re-extracted")), first)
    # stale key, other dtype or other boxes: re-extracted and overwritten
    _resolve(gr, union, im, path, fn, key="other")
    assert calls == [0, 1, 2] * 2
    _resolve(gr, union, im, path, fn, key="other", dtype="float16")
    assert len(calls) == 9
    # a torn file is a miss, and is replaced
    with open(path, "wb") as f:
        f.write(b"\x00garbage")
    np.testing.assert_array_equal(_resolve(gr, union, im, path, fn), first)
    assert len(calls) == 12
    # a failed provider: bucket-sized zeros, never cached
    os.remove(path)
    got = _resolve(gr, union, im, path, lambda f, b: None)
    assert got.shape == (8, 7, 7, FEAT) and not got.any() and not os.path.exists(path)
