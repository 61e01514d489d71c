"""Full STTran sgdet eval forward: the port against the JAX package's eval
step on the same Entries and the same weights (the port's random weights
carried into the flax tree by convert_ref.convert_sttran).

The 3-video batch holds a normal video, one whose valid relations all sit
in frame 0 (zero windows: the wk fallback) and an all-padding fill video,
so the per-video reductions of the batched port are pinned against JAX's
vmap. feat_dim 2048 at small R, as tests/test_model_parity.py, and its
2e-4 tolerance (float32 on both sides; sums in another order).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.models.convert_ref import convert_sttran
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.train.step import make_eval_step, stack_entries as j_stack
from nl_vsgg_tpu_torch import serve
from nl_vsgg_tpu_torch.data.entry import Entry, empty_entry, stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.step import eval_step, place_entries
from tests.fixtures import load_tool

FEAT = 2048
NB, NR = 16, 12
ATOL = 2e-4
_State = collections.namedtuple("_State", "params batch_stats")  # a pytree
HEADS = ("attention_distribution", "spatial_distribution",
         "contacting_distribution", "distribution", "global_output")


def mixed_batch(seed=3):
    """[normal video, frame-0-only video, fill video] as port Entries."""
    rng = np.random.default_rng(seed)
    normal = make_synthetic_entry(rng, n_frames=4, objs_per_frame=2,
                                  bucket_boxes=NB, bucket_rels=NR, feat_dim=FEAT)
    f0 = make_synthetic_entry(rng, n_frames=3, objs_per_frame=2,
                              bucket_boxes=NB, bucket_rels=NR, feat_dim=FEAT)
    f0 = f0.replace(rel_mask=f0.rel_mask & (f0.im_idx == 0))
    return [normal, f0, empty_entry(NB, NR, FEAT)]


def to_jax_entry(e: Entry):
    return jentry.Entry(**{f.name: getattr(e, f.name).numpy()
                           for f in dataclasses.fields(Entry)})


def jax_forward(model_t, entries, fusion, variant="wk"):
    params, stats, unused = convert_sttran(model_t.state_dict())
    assert unused == []
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, transformer_fusion=fusion,
                 transformer_variant=variant)
    state = _State(params, stats)
    batch = jax.tree.map(jax.numpy.asarray, j_stack([to_jax_entry(e) for e in entries]))
    return jax.device_get(jax.jit(make_eval_step(jm))(state, batch))


@pytest.mark.parametrize("fusion,variant", [("latter", "wk"), ("both", "wk"),
                                            ("latter", "org")])
def test_sttran_eval_matches_jax(fusion, variant):
    entries = mixed_batch()
    model = STTran(mode="sgdet", feat_dim=FEAT, transformer_fusion=fusion,
                   transformer_variant=variant, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    ours = eval_step(model, stack_entries(entries))
    ref = jax_forward(model, entries, fusion, variant)
    for k in HEADS:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    # the frame-0-only video really took the fallback: wk passes the encoder
    # output through (nonzero), org returns zeros
    g1 = ours["global_output"][1][entries[1].rel_mask]
    assert g1.abs().max() > 0 if variant == "wk" else g1.abs().max() == 0


def test_union_and_mask_sentinels_match_jax():
    """Width-0 union_feat (bias broadcast) and width-0 spatial_masks
    (masks rasterized from the pair boxes) against the JAX model."""
    entries = [e.replace(union_feat=e.union_feat[..., :0],
                         spatial_masks=e.spatial_masks[..., :0])
               for e in mixed_batch(seed=4)]
    model = STTran(mode="sgdet", feat_dim=FEAT, device="cpu",
                   generator=torch.Generator().manual_seed(6))
    ours = eval_step(model, stack_entries(entries))
    ref = jax_forward(model, entries, "latter")
    for k in HEADS:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


@pytest.fixture()
def no_flax_dropout(monkeypatch):
    """flax Dropout as the identity (tests/test_train_trajectory.py's patch):
    the two packages draw different random streams."""
    import flax.linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def test_train_forward_matches_jax(no_flax_dropout):
    """Train mode, dropout off on both sides: every head and every
    BatchNorm's validity-weighted running update against the JAX model run
    per video. The three videos have different statistics, so BatchNorm
    pooled over the batch (or over the mask tower's B*R rows) would fail."""
    entries = mixed_batch(seed=11)
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0, device="cpu",
                   generator=torch.Generator().manual_seed(8))
    params, stats, _ = convert_sttran(model.state_dict())
    params, stats = jax.tree.map(jax.numpy.array, (params, stats))  # copies
    batch = stack_entries(entries)
    ours = model(batch, train=True, generator=torch.Generator().manual_seed(0))
    vid_w = batch.box_mask.any(-1)
    for m in model.modules():
        if hasattr(m, "commit"):
            m.commit(vid_w)
    _, new_stats, _ = convert_sttran(model.state_dict())

    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)

    def per_video(entry):
        pred, upd = jm.apply({"params": params, "batch_stats": stats}, entry, train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return pred, upd["batch_stats"]

    jbatch = jax.tree.map(jax.numpy.asarray, j_stack([to_jax_entry(e) for e in entries]))
    ref, ref_stats = jax.device_get(jax.jit(jax.vmap(per_video))(jbatch))
    for k in HEADS:
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    w = np.asarray(vid_w, np.float32)

    def check(path, leaf):
        node = new_stats
        for key in path:
            node = node[key.key]
        expect = np.where(w.reshape(-1, *[1] * (leaf.ndim - 1)) > 0,
                          leaf * w.reshape(-1, *[1] * (leaf.ndim - 1)), 0).sum(0) / w.sum()
        np.testing.assert_allclose(node, expect, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))

    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_stats):
        check(path, np.asarray(leaf))


def test_scene_graph_json_matches_predict_tool():
    load_tool("train_STTran")  # tools/predict.py imports it by module name
    predict_tool = load_tool("predict")
    entries = mixed_batch(seed=7)[:2]
    model = STTran(feat_dim=FEAT, device="cpu")
    graphs = serve.predict(model, entries, batch=3, device="cpu",
                           video_ids=["a", "b"], topk=20)
    assert [g["video"] for g in graphs] == ["a", "b"]
    pred = eval_step(model, stack_entries(entries + [entries[0]]))
    tax_j = jschema.load_taxonomy()
    for i, (vid, e) in enumerate(zip("ab", entries)):
        p = {k: pred[k][i].numpy() for k in serve.NEEDED}
        ref = predict_tool.scene_graph_json(vid, to_jax_entry(e), p, tax_j, 20)
        assert graphs[i] == ref


def test_predict_batches_keep_input_order():
    """3 videos in batches of 2 (one full, one padded leftover) give the
    same graphs as one batch of 3."""
    entries = mixed_batch(seed=8)[:2] + mixed_batch(seed=9)[:1]
    model = STTran(feat_dim=FEAT, device="cpu")
    one = serve.predict(model, entries, batch=3, device="cpu", topk=10)
    two = serve.predict(model, entries, batch=2, device="cpu", topk=10)
    assert [g["video"] for g in two] == ["0", "1", "2"]
    for a, b in zip(one, two):
        assert a["objects"] == b["objects"]
        assert [t["predicate"] for t in a["triplets"]] == [t["predicate"] for t in b["triplets"]]
        np.testing.assert_allclose([t["score"] for t in a["triplets"]],
                                   [t["score"] for t in b["triplets"]], atol=1e-4)


def test_bf16_compute_follows_fp32():
    """dtype=bfloat16 (the serving configuration) on the same weights:
    heads within 5e-2 of float32 (bf16 keeps 8 bits through every
    projection, convolution and attention), object head exactly float32."""
    entries = mixed_batch(seed=10)
    g = torch.Generator().manual_seed(12)
    f32 = STTran(feat_dim=FEAT, device="cpu", generator=g)
    b16 = STTran(feat_dim=FEAT, device="cpu", dtype=torch.bfloat16)
    b16.load_state_dict(f32.state_dict())
    batch = stack_entries(entries)
    ref, out = eval_step(f32, batch), eval_step(b16, place_entries(entries, rel_bf16=True, device="cpu"))
    for k in ("attention_distribution", "spatial_distribution", "contacting_distribution"):
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=5e-2, err_msg=k)
    np.testing.assert_array_equal(out["distribution"].numpy(), ref["distribution"].numpy())
