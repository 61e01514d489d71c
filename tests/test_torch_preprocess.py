"""The port's offline tools (`nl_vsgg_tpu_torch.tools.preprocess`,
`convert_vinvl`, `validate_ckpt`) and the detector's .npz checkpoints
against the JAX package's tools on the CPU.

  * the preprocess chain img-info -> tcs -> triplets -> adv -> negatives
    (and dets-cache) through both tools' argparse surfaces on the same
    inputs, the LLM a stub: every pickle equal;
  * `features` on one frame in both tools from one VinVL .pth: the
    detections matched by label and corners, scores and features within
    the detector tolerance of tests/test_torch_detector.py (corners 0.05
    px, scores 1e-3 relative, features 1e-4 of the largest magnitude: the
    same float32 math through 50 residual blocks in another order). The
    frame is 96 x 1000, which both packages' resize keeps as it is (the
    longer side already at the 1000 cap): at other sizes cv2's fixed-point
    resize and the port's float resize differ by up to one pixel unit
    (tests/test_torch_detector.py), which random weights amplify;
  * the .npz checkpoint: `convert_vinvl`'s keys and arrays equal to the JAX
    tool's, each package's loader on the other's file, the JAX package's
    packed and legacy compact conv2 layouts, exact;
  * both `validate_ckpt` commands: a good file passes, a bad one fails;
  * a missing cv2 named.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.detector.convert import convert_state_dict, load_checkpoint as jax_load
from nl_vsgg_tpu_torch.data.grounding import DETS_F32, dets_to_f32
from nl_vsgg_tpu_torch.detector import convert
from nl_vsgg_tpu_torch.pipelines import clip
from nl_vsgg_tpu_torch.tools import convert_vinvl, preprocess, validate_ckpt
from tests.fixtures import load_tool, make_vinvl_state_dict
from tests.test_torch_pipelines import dac_state_dict, same

cv2 = pytest.importorskip("cv2")

TCS_RESPONSE = ("Output:  A person opens a door. >> "
                "The person picks up a book. >> The person reads a book.")
TRIPLET_RESPONSE = (
    "Input: A person opens a door. Output: Step 1: <person, opens, door>. "
    "Step 2: <1.person, 22.touching, 13.door>.\n"
    "Input: The person picks up a book. Output: Step 1: <person, picks up, book>. "
    "Step 2: <1.person, 15.holding, 5.book>, <1.person, 1.looking at, 5.book>.\n"
    "Input: The person reads a book. Output: Step 1: <person, reads, book>. "
    "Step 2: <1.person, 1.looking at, 5.book>.")
BOX_PX, SCORE_REL, FEAT_REL = 0.05, 1e-3, 1e-4


def rel_err(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def run_jax(monkeypatch, tool, argv):
    monkeypatch.setattr(sys, "argv", ["preprocess.py"] + argv)
    tool.main()


@pytest.fixture(scope="module")
def jax_tools():
    return load_tool("preprocess"), load_tool("convert_vinvl")


@pytest.fixture(scope="module")
def vinvl(tmp_path_factory):
    """A full-size VinVL checkpoint-layout state dict (folded-BN statistics
    random, convs at fan-in scale, bn3 / downsample scales 0.2 so that 50
    random blocks stay finite, as tests/test_torch_detector.py scales it),
    written as a .pth with attribute-head and anchor keys beside it."""
    sd = make_vinvl_state_dict(np.random.default_rng(11), randomize_bn=True)
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 4:
            sd[k] = (v / 0.05 * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        elif k.endswith(("bn3.weight", "downsample.1.weight")):
            sd[k] = v * np.float32(0.2)
    extra = {"roi_heads.attribute.predictor.att_score.weight": np.zeros((401, 8), np.float32),
             "rpn.anchor_generator.cell_anchors.0": np.zeros((15, 4), np.float32)}
    path = str(tmp_path_factory.mktemp("vinvl") / "vinvl.pth")
    torch.save({"model": {k: torch.as_tensor(v) for k, v in {**sd, **extra}.items()}}, path)
    return sd, path


# ------------------------------------------------------------ the chain
def _write_chain_inputs(root, vids, T):
    rng = np.random.default_rng(2)
    _, ag_to_oi = jschema.load_oi_ag_maps()
    tax = jschema.load_taxonomy()
    frames = [f"{i + 1:06d}.png" for i in range(T)]
    emb = {}
    for n, vid in enumerate(vids):
        os.makedirs(root / "frames" / vid)
        cv2.imwrite(str(root / "frames" / vid / frames[0]),
                    np.zeros((480 - 60 * n, 640, 3), np.uint8))
        protos = rng.standard_normal((3, 16))
        text = protos + 0.01 * rng.standard_normal((3, 16))
        # three phases of 3 frames, one a sentence, then frames that match none
        vis = np.concatenate([protos[i] + 0.05 * rng.standard_normal((3, 16))
                              for i in range(3)] + [rng.standard_normal((T - 9, 16))])
        emb[vid] = {"text": [text.astype(np.float32)], "frames": vis.astype(np.float32)}
        for i, fr in enumerate(frames):   # objects leaving a fixed person in the last frames
            d = root / "frame_features" / vid / fr
            os.makedirs(d)
            dets = [{"class": ag_to_oi[1][0], "conf": np.float32(0.9),
                     "rect": np.array([10, 10, 100, 200], np.float32)}]
            for j, obj in enumerate(("door", "book")):
                x0 = 10 + (80 + 20 * j) * max(0, i - 9)
                dets.append({"class": ag_to_oi[list(tax.object_classes_pipeline).index(obj)][0],
                             "conf": np.float32(0.8),
                             "rect": np.array([x0, 10, x0 + 100, 200], np.float32)})
            np.save(str(d / "dets.npy"), np.asarray(dets, object), allow_pickle=True)
    with open(root / "captions.csv", "w") as f:
        f.write("id,descriptions\n" + "".join(
            f"{v[:-4]},A person opens a door then picks up a book and reads it\n" for v in vids))
    pickle.dump({vid: frames for vid in vids}, open(root / "ids.pkl", "wb"))
    pickle.dump(emb, open(root / "emb.pkl", "wb"))


def _chain_argvs(root, out):
    o = lambda name: str(out / name)  # noqa: E731
    return [
        ["img-info", "--frames", str(root / "frames"), "--output", o("info.pkl")],
        ["tcs", "--captions", str(root / "captions.csv"), "--frame_ids",
         str(root / "ids.pkl"), "--output", o("split.pkl"), "--api_key", "unused"],
        ["triplets", "--split_actions", o("split.pkl"), "--frame_ids", str(root / "ids.pkl"),
         "--output", o("tri.pkl"), "--api_key", "unused"],
        ["adv", "--triplets", o("tri.pkl"), "--embeddings", str(root / "emb.pkl"),
         "--semi_output", o("semi.pkl"), "--output", o("final.pkl")],
        ["negatives", "--final", o("final.pkl"), "--semi", o("semi.pkl"),
         "--features", str(root / "frame_features"), "--output", o("neg.pkl")],
    ]


def test_preprocess_chain_matches_jax(tmp_path, monkeypatch, jax_tools):
    pre = jax_tools[0]
    vids = ["v001.mp4", "v002.mp4"]
    _write_chain_inputs(tmp_path, vids, T=12)
    outs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        out.mkdir()
        for argv in _chain_argvs(tmp_path, out):
            llm = TCS_RESPONSE if argv[0] == "tcs" else TRIPLET_RESPONSE
            if name == "jax":
                monkeypatch.setattr(pre, "_openai_llm", lambda m, k, r=llm: (lambda p: r))
                run_jax(monkeypatch, pre, argv)
            else:
                preprocess.main(argv, llm=lambda p, r=llm: r)
        outs[name] = {f: pickle.load(open(out / f, "rb")) for f in sorted(os.listdir(out))}
    assert outs["port"].keys() == outs["jax"].keys() == {
        "info.pkl", "split.pkl", "tri.pkl", "semi.pkl", "final.pkl", "neg.pkl"}
    for f, got in outs["port"].items():
        assert same(got, outs["jax"][f]), f
    info, neg = outs["port"]["info.pkl"], outs["port"]["neg.pkl"]
    assert tuple(info["v001.mp4"].shape) == (1, 3) and info["v001.mp4"].dtype == torch.float32
    np.testing.assert_allclose(info["v001.mp4"].numpy()[0], [600.0, 800.0, 1.25])
    assert set(neg) == set(vids) and all(len(neg[v]) == 12 for v in vids)
    labeled = [d for v in vids for fr in neg[v] for d in fr if "class" in d]
    assert labeled and any(1 in d["attention_relationship"] for d in labeled)

    # dets-cache on the features tree: the same sidecars
    for name in ("jax", "port"):
        argv = ["dets-cache", "--frame_features", str(tmp_path / "frame_features"), "--force"]
        if name == "jax":
            run_jax(monkeypatch, pre, argv)
            ref = np.load(tmp_path / "frame_features" / vids[0] / "000003.png" / DETS_F32)
        else:
            preprocess.main(argv)
            got = np.load(tmp_path / "frame_features" / vids[0] / "000003.png" / DETS_F32)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


# ------------------------------------------------------------- features
@pytest.fixture(scope="module")
def features_runs(vinvl, jax_tools, tmp_path_factory):
    """Both tools' `features` on one 96 x 1000 frame from the .pth."""
    root = tmp_path_factory.mktemp("features")
    os.makedirs(root / "frames" / "v1.mp4")
    img = np.random.default_rng(6).integers(0, 256, (96, 1000, 3), dtype=np.uint8)
    cv2.imwrite(str(root / "frames" / "v1.mp4" / "000001.png"), img)
    argv = ["features", "--frames", str(root / "frames"), "--checkpoint", vinvl[1]]
    saved = sys.argv
    try:
        sys.argv = ["preprocess.py"] + argv + ["--output", str(root / "jax")]
        jax_tools[0].main()
    finally:
        sys.argv = saved
    preprocess.main(argv + ["--output", str(root / "port"), "--device", "cpu"])
    return {name: root / name / "v1.mp4" / "000001.png" for name in ("jax", "port")}


def test_features_match_jax(features_runs):
    load = {n: {f: np.load(d / f, allow_pickle=True) for f in ("dets.npy", DETS_F32, "feat.npy")}
            for n, d in features_runs.items()}
    ref, got = load["jax"], load["port"]
    rd, gd = ref["dets.npy"].tolist(), got["dets.npy"].tolist()
    assert len(gd) == len(rd) >= 5
    assert all(set(d) == {"class", "conf", "rect"} and type(d["class"]) is int
               and d["conf"].dtype == np.float32 and d["rect"].dtype == np.float32 for d in gd)
    np.testing.assert_array_equal(got[DETS_F32], dets_to_f32(gd))
    assert got["feat.npy"].dtype == np.float32 and got["feat.npy"].shape == (len(gd), 2048)
    rbox = np.stack([d["rect"] for d in rd])
    gbox = np.stack([d["rect"] for d in gd])
    near = np.abs(rbox[:, None] - gbox[None]).max(-1) < BOX_PX
    match = near & (np.array([d["class"] for d in rd])[:, None]
                    == np.array([d["class"] for d in gd])[None])
    assert match.any(1).all(), "a JAX detection has no match in the port's list"
    j = match.argmax(1)
    np.testing.assert_allclose([gd[i]["conf"] for i in j], [d["conf"] for d in rd],
                               rtol=SCORE_REL)
    assert rel_err(got["feat.npy"][j], ref["feat.npy"]) < FEAT_REL


def test_features_without_checkpoint(tmp_path, capsys):
    """Seeded random weights, with the JAX tool's warning."""
    os.makedirs(tmp_path / "frames" / "v.mp4")
    frames = {"000001.png": np.full((64, 1000, 3), 90, np.uint8),
              "000002.png": np.full((64, 1000, 3), 160, np.uint8)}
    for f in frames:                                   # the listing the tool reads
        (tmp_path / "frames" / "v.mp4" / f).touch()
    preprocess.main(["features", "--frames", str(tmp_path / "frames"), "--output",
                     str(tmp_path / "out"), "--device", "cpu"],
                    read_image=lambda p: frames[os.path.basename(p)])
    assert "WARNING: no --checkpoint; random weights" in capsys.readouterr().out
    for f in frames:
        d = tmp_path / "out" / "v.mp4" / f
        dets = np.load(d / "dets.npy", allow_pickle=True).tolist()
        np.testing.assert_array_equal(np.load(d / DETS_F32), dets_to_f32(dets))
        assert np.load(d / "feat.npy").shape == (len(dets), 2048)


# ------------------------------------------------------ .npz checkpoints
def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_convert_vinvl_matches_jax(vinvl, jax_tools, tmp_path, monkeypatch):
    """Both tools on one .pth, compression off in both (np.savez_compressed
    takes about 30 s a file of random weights on the CPU and changes no key
    or array)."""
    sd, pth = vinvl
    monkeypatch.setattr(np, "savez_compressed", np.savez)
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["convert_vinvl.py", pth, jax_npz])
    jax_tools[1].main()
    n = convert_vinvl.main([pth, port_npz])
    with np.load(jax_npz) as ref, np.load(port_npz) as got:
        assert n == len(got.files) and sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            assert np.array_equal(got[k], ref[k]), k
    # each package reads the other's file
    theirs = dict(_leaves(jax_load(port_npz)))
    assert theirs.keys() == dict(_leaves(convert_state_dict(sd))).keys()
    for k, v in _leaves(convert_state_dict(sd)):
        assert np.array_equal(theirs[k], v), k
    mine = convert.load_checkpoint(jax_npz)
    want = convert.from_maskrcnn_state_dict(sd)
    assert mine.keys() == want.keys() and all(torch.equal(mine[k], want[k]) for k in want)


def _compact(variables, sd):
    """The JAX variables with every conv2 kernel in the compact grouped
    layout (3, 3, C/32, C), as .npz files written before group packing."""
    params = variables["params"]
    stages = [(params["backbone"][f"layer{k}"], f"backbone.body.layer{k}") for k in (1, 2, 3)]
    stages.append((params["box_head"]["head"]["layer4"],
                   "roi_heads.box.feature_extractor.head.layer4"))
    for stage, src in stages:
        for name, block in stage.items():
            block["conv2"]["kernel"] = np.asarray(
                sd[f"{src}.{name[5:]}.conv2.weight"]).transpose(2, 3, 1, 0)
    return variables


@pytest.mark.parametrize("layout", ["packed", "compact", "pth"])
def test_load_checkpoint_layouts(vinvl, tmp_path, layout):
    sd, pth = vinvl
    path = pth
    if layout != "pth":
        variables = convert_state_dict(sd)
        if layout == "compact":
            variables = _compact(variables, sd)
            assert variables["params"]["backbone"]["layer1"]["block0"]["conv2"][
                "kernel"].shape == (3, 3, 8, 256)
        path = str(tmp_path / f"{layout}.npz")
        np.savez(path, **dict(_leaves(variables)))   # the JAX save_npz's keys, uncompressed
    got = convert.load_checkpoint(path)
    want = convert.from_maskrcnn_state_dict(sd)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def test_pack_inverts_unpack():
    w = np.random.default_rng(3).standard_normal((3, 3, 8, 256)).astype(np.float32)
    for eff in (1, 4, 8, 32):
        np.testing.assert_array_equal(
            convert.unpack_grouped_kernel(convert.pack_grouped_kernel(w, 32, eff)), w)


# ------------------------------------------------------------ validate_ckpt
def test_validate_vinvl_good_and_bad(vinvl, monkeypatch, capsys):
    assert validate_ckpt.main(["vinvl", vinvl[1], "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for stage in ("stem", "C2", "C3", "C4", "rpn_logits", "rpn_deltas", "C5", "cls_score",
                  "bbox_pred"):
        assert f"  {stage} " in out
    assert "skipped 2 attribute/anchor keys" in out and "FAIL" not in out

    real = validate_ckpt.from_maskrcnn_state_dict

    def bad_fold(sd):  # a converter fault: the stem's channels in the wrong order
        out = real(sd)
        out["backbone.stem_conv1.weight"] = out["backbone.stem_conv1.weight"].flip(1)
        return out

    monkeypatch.setattr(validate_ckpt, "from_maskrcnn_state_dict", bad_fold)
    assert validate_ckpt.main(["vinvl", vinvl[1], "--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_validate_clip_good_and_orphan(tmp_path, capsys):
    sd = dac_state_dict(np.random.default_rng(8))
    good = str(tmp_path / "llm_cp.pt")
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}}, good)
    assert validate_ckpt.main(["clip", good, "--atol", "5e-3", "--device", "cpu"]) == 0
    logs = []
    diffs = clip.validate_checkpoint(good, log=logs.append, device="cpu")
    assert diffs.pop("_ok") == 1.0 and set(diffs) == {"visual_embed", "text_embed"}
    assert max(diffs.values()) < 1e-4, logs
    # an adapter spelling nobody resolves fails loudly, not agree-by-skip
    sd["visual.unknown_module.lora_A"] = np.zeros((4, clip.VISION_WIDTH), np.float32)
    orphan = str(tmp_path / "llm_cp_orphan.pt")
    torch.save({"state_dict": {k: torch.as_tensor(v) for k, v in sd.items()}}, orphan)
    diffs = clip.validate_checkpoint(orphan, log=logs.append, device="cpu")
    assert diffs["_ok"] == 0.0 and diffs["unconsumed_lora_keys"] == 1.0
    assert validate_ckpt.main(["clip", orphan, "--device", "cpu"]) == 1


# ------------------------------------------------------------------ cv2
def test_missing_cv2_named(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        preprocess.cv2_image_reader()
    for cmd in ("img-info", "features"):
        with pytest.raises(ImportError, match="read_image="):
            preprocess.main([cmd, "--frames", str(tmp_path), "--output", str(tmp_path / "o")])
    # the subcommands that read no frame need no cv2
    preprocess.main(["dets-cache", "--frame_features", str(tmp_path)])


def test_features_needs_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    os.makedirs(tmp_path / "frames")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess.main(["features", "--frames", str(tmp_path / "frames"), "--output",
                         str(tmp_path / "o")], read_image=lambda p: None)
