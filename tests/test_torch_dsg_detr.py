"""DSG-DETR: the port against the JAX package on the same Entries and the
same weights.

* `sequence_ordinal` and `tracklet_rank` exactly equal the JAX functions
  (duplicated anchors, singleton groups, padded rows).
* `sinusoidal_position_table`, `SinusoidalPE`, `TorchEncoderLayer` and
  `mlp` against flax at 2e-5 (the same float32 math in another order; the
  layer's LayerNorm eps is set to flax's 1e-6 here, the port keeping
  torch's 1e-5); the whole table adds its float32 conditioning at large
  positions (see its test).
* The whole model's eval forward in sgdet, sgcls (tracker group ids) and
  predcls on weights drawn by flax and carried by
  models/convert.dsg_detr_from_jax, and in sgdet also on weights drawn by
  the port and carried by convert_ref.convert_dsg_detr, at 2e-4 on every
  output, as tests/test_torch_sttran.py: float32 on both sides, sums in
  another order through 4 layers (7 in sgcls).
* The sgdet train-mode forward with dropout off on both sides (the two
  packages draw different random streams), heads at 2e-4 and every
  BatchNorm's running update at 1e-5 relative; the sgcls train-mode
  forward (tracker group ids) likewise, and the gradients of a fixed
  scalar loss of its outputs for the tracklet head's parameters (the
  float32 encoder whose attention runs on the tiled route on a card).
* Weight round trips through both converters, exact.

feat_dim 2048 at small R, a few frames. The batch holds a video with a
random class per object, one whose objects keep their class through every
frame (tracklets: dense same-class masks), and an all-padding fill video.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.models import convert_ref
from nl_vsgg_tpu.models import dsg_detr as jd
from nl_vsgg_tpu.models import layers as jl
from nl_vsgg_tpu.train.step import stack_entries as j_stack
from nl_vsgg_tpu_torch.data.entry import Entry, empty_entry, stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models import dsg_detr as td
from nl_vsgg_tpu_torch.models import layers as tl
from nl_vsgg_tpu_torch.models.convert import dsg_detr_from_jax
from nl_vsgg_tpu_torch.models.sttran import init_weights
from nl_vsgg_tpu_torch.models.track import sgcls_group_ids
from nl_vsgg_tpu_torch.train.step import eval_step

FEAT = 2048
NB, NR, FRAMES, OBJS = 16, 12, 4, 2
ATOL = 2e-4
HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
         "global_output")


def tracklet_video(e: Entry, rng) -> Entry:
    """The same video with each object slot keeping one class (drawn once)
    through every frame, its distribution peaked on it."""
    labels, dist = e.labels.clone(), e.distribution.clone()
    nb = int(e.box_mask.sum())
    slot = torch.arange(nb) % (OBJS + 1)
    classes = torch.as_tensor(rng.integers(2, 37, OBJS + 1))
    for i in range(nb):
        if slot[i] > 0:
            labels[i] = classes[slot[i]]
            dist[i] = torch.full((36,), 0.01)
            dist[i, labels[i] - 1] = 0.65
    return e.replace(labels=labels, distribution=dist)


def batch_entries(seed=3):
    rng = np.random.default_rng(seed)
    mk = lambda: make_synthetic_entry(rng, n_frames=FRAMES, objs_per_frame=OBJS,  # noqa: E731
                                      bucket_boxes=NB, bucket_rels=NR, feat_dim=FEAT)
    return [mk(), tracklet_video(mk(), rng), empty_entry(NB, NR, FEAT)]


def to_jax_entry(e: Entry):
    return jentry.Entry(**{f.name: getattr(e, f.name).numpy()
                           for f in dataclasses.fields(Entry)})


def jbatch(entries):
    return jax.tree.map(jnp.asarray, j_stack([to_jax_entry(e) for e in entries]))


def group_ids(entries):
    return torch.from_numpy(np.stack([sgcls_group_ids(e, (480.0, 640.0)) for e in entries]))


# ----------------------------------------------------------- positions
def test_sequence_ordinal_and_tracklet_rank_exact():
    rng = np.random.default_rng(0)
    L = 40
    gid = rng.integers(0, 5, (6, L)).astype(np.int32)
    gid[:, ::13] = 100 + np.arange(4)          # singleton groups
    anchor = rng.integers(0, 6, (6, L)).astype(np.int32)  # many duplicated anchors
    valid = rng.random((6, L)) < 0.8
    valid[:, -5:] = False                       # padding
    valid[5] = False                            # an all-padding row set
    got_o = td.sequence_ordinal(torch.from_numpy(gid), torch.from_numpy(valid))
    got_r = td.tracklet_rank(torch.from_numpy(gid), torch.from_numpy(anchor),
                             torch.from_numpy(valid))
    ref_o = jd.sequence_ordinal(jnp.asarray(gid), jnp.asarray(valid))
    ref_r = jd.tracklet_rank(jnp.asarray(gid), jnp.asarray(anchor), jnp.asarray(valid))
    assert got_o.dtype == got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))
    assert got_r.max() > 1 and got_o.max() > 3


@pytest.mark.parametrize("max_len,d_model", [(400, 1936), (600, 2376)])
def test_sinusoidal_table(max_len, d_model):
    """2e-5, plus the table's own float32 conditioning: each side rounds a
    frequency w to float32 (up to 2^-24 relative; the two exp
    implementations differ by that ulp), which moves the angle p w by up to
    p 2^-24 at position p. Both tables lie 3e-5 from a float64 table at
    position 399; against each other the difference is up to twice that."""
    tol = 2e-5 + 2 * (max_len - 1) * 2.0 ** -24
    np.testing.assert_allclose(tl.sinusoidal_position_table(max_len, d_model).numpy(),
                               np.asarray(jl.sinusoidal_position_table(max_len, d_model)),
                               rtol=0, atol=tol)


def test_sinusoidal_pe_clips_positions():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.array([[0, 1, 5, 39, 40, 41, 500, 3, 2]] * 2, np.int32)
    ours = td.SinusoidalPE(64, max_len=40)(torch.from_numpy(x), torch.from_numpy(pos))
    ref = jd.SinusoidalPE(64, max_len=40).apply({}, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_torch_encoder_layer():
    rng = np.random.default_rng(2)
    E, H, FF, B, L = 48, 4, 64, 3, 10
    m = tl.TorchEncoderLayer(E, H, FF)
    init_weights(m, torch.Generator().manual_seed(0))
    m.eval()
    for norm in (m.norm1, m.norm2):
        norm.eps = 1e-6  # flax's LayerNorm eps
    sd = convert_ref._SD({f"m.{k}": v for k, v in m.state_dict().items()})
    params = {"params": convert_ref._encoder_layer(sd, "m")}
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    allow = rng.random((B, L, L)) < 0.5
    allow[:, 2] = False  # a row with no allowed key
    ours = m(torch.from_numpy(x), torch.from_numpy(allow))
    ref = jl.TorchEncoderLayer(E, H, FF).apply(params, jnp.asarray(x), jnp.asarray(allow))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=2e-5)


def test_mlp():
    """The port's `mlp(in, widths)` against flax's `mlp(widths)` (Dense_i
    kernels are the transposed Linear weights), ReLU between layers: 2e-5."""
    rng = np.random.default_rng(3)
    m = tl.mlp(16, [32, 24, 8])
    init_weights(m, torch.Generator().manual_seed(1))
    linears = [layer for layer in m if isinstance(layer, torch.nn.Linear)]
    params = {"params": {f"Dense_{i}": {"kernel": layer.weight.detach().numpy().T,
                                        "bias": layer.bias.detach().numpy()}
                         for i, layer in enumerate(linears)}}
    x = rng.standard_normal((5, 16)).astype(np.float32)
    ref = jl.mlp([32, 24, 8]).apply(params, jnp.asarray(x))
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               rtol=0, atol=2e-5)


# ----------------------------------------------------------- the model
def perturbed(variables, seed):
    """flax's fresh init leaves BatchNorm statistics at (0, 1) and norms at
    the identity: move them, so the conversion is seen on every tensor."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "'var'" in name:
            return leaf * rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if "'mean'" in name or "'scale'" in name or "norm" in name:
            return leaf + rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, variables)


def jax_eval(jm, params, stats, entries, gid=None):
    params, stats = jax.tree.map(jnp.asarray, (params, stats))

    def per_video(e, g):
        return jm.apply({"params": params, "batch_stats": stats}, e, train=False,
                        group_id=g)

    if gid is None:
        return jax.device_get(jax.jit(jax.vmap(lambda e: per_video(e, None)))(jbatch(entries)))
    return jax.device_get(jax.jit(jax.vmap(per_video))(jbatch(entries),
                                                       jnp.asarray(gid.numpy())))


def check(ours, ref, keys):
    for k in keys:
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_sgdet_eval_matches_jax():
    entries = batch_entries()
    model = td.DSGDETR(mode="sgdet", feat_dim=FEAT, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    params, stats, unused = convert_ref.convert_dsg_detr(model.state_dict())
    assert unused == []
    ref = jax_eval(jd.DSGDETR(mode="sgdet", feat_dim=FEAT), params, stats, entries)
    ours = eval_step(model, stack_entries(entries))
    check(ours, ref, HEADS + ("distribution",))
    # the tracklet video's global layers see same-class sets across frames
    allow_t = td._same_group(td._take(stack_entries(entries).labels,
                                      stack_entries(entries).pair_idx[..., 1]),
                             stack_entries(entries).rel_mask)
    assert allow_t[1].float().mean() > allow_t[0].float().mean()


@pytest.mark.parametrize("mode", ["sgdet", "sgcls", "predcls"])
def test_eval_on_jax_weights_matches_jax(mode):
    entries = batch_entries(seed=4)
    sample = jax.tree.map(jnp.asarray, to_jax_entry(entries[0]))
    jm = jd.DSGDETR(mode=mode, feat_dim=FEAT)
    gid = group_ids(entries) if mode == "sgcls" else None
    variables = jax.jit(lambda key, e, g: jm.init(key, e, train=False, group_id=g))(
        jax.random.key(0), sample, None if gid is None else jnp.asarray(gid[0].numpy()))
    variables = perturbed(variables, 6)
    params, stats = variables["params"], variables.get("batch_stats", {})
    model = td.DSGDETR(mode=mode, feat_dim=FEAT, device="cpu")
    model.load_state_dict(dsg_detr_from_jax(params, stats))
    ref = jax_eval(jm, params, stats, entries, gid)
    with torch.inference_mode():
        ours = model(stack_entries(entries), group_id=gid)
    check(ours, ref, HEADS + (("distribution",) if mode != "predcls" else ()))
    if mode == "sgcls":  # the tracker joined each slot's boxes across frames
        assert len(set(gid[1, :int(entries[1].box_mask.sum())].tolist())) < int(
            entries[1].box_mask.sum())


_State = collections.namedtuple("_State", "params batch_stats")


@pytest.fixture()
def no_flax_dropout(monkeypatch):
    import flax.linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def test_sgdet_train_forward_matches_jax(no_flax_dropout):
    entries = batch_entries(seed=11)
    model = td.DSGDETR(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0,
                       device="cpu", generator=torch.Generator().manual_seed(8))
    params, stats, _ = convert_ref.convert_dsg_detr(model.state_dict())
    params, stats = jax.tree.map(jnp.array, (params, stats))
    batch = stack_entries(entries)
    ours = model(batch, train=True, generator=torch.Generator().manual_seed(0))
    vid_w = batch.box_mask.any(-1)
    for m in model.modules():
        if hasattr(m, "commit"):
            m.commit(vid_w)
    _, new_stats, _ = convert_ref.convert_dsg_detr(model.state_dict())

    jm = jd.DSGDETR(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)

    def per_video(entry):
        pred, upd = jm.apply({"params": params, "batch_stats": stats}, entry, train=True,
                             mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return pred, upd["batch_stats"]

    ref, ref_stats = jax.device_get(jax.jit(jax.vmap(per_video))(jbatch(entries)))
    check(ours, ref, HEADS + ("distribution",))
    w = np.asarray(vid_w, np.float32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_stats):
        node = new_stats
        for key in path:
            node = node[key.key]
        leaf = np.asarray(leaf)
        wb = w.reshape(-1, *[1] * (leaf.ndim - 1))
        expect = np.where(wb > 0, leaf * wb, 0).sum(0) / w.sum()
        np.testing.assert_allclose(node, expect, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


# a gradient of the sgcls loss, port against JAX, per tensor: float32 sums in
# another order through 7 layers and their backward: |dg| <= 1e-3 |g| + 1e-5
# of the largest gradient magnitude of the head (a bias whose output a
# train-mode BatchNorm re-centres has an exact gradient of 0: noise on both
# sides)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5


def test_sgcls_train_forward_matches_jax(no_flax_dropout):
    """sgcls in train mode, dropout off, tracker group ids, on weights drawn
    by flax: the outputs at 2e-4, and the gradients of a fixed weighted sum
    of the outputs with respect to the tracklet head's parameters
    (`object_classifier.*`, carried through `dsg_detr_from_jax` like the
    weights: the converter only transposes and stacks)."""
    entries = batch_entries(seed=12)
    gid = group_ids(entries)
    sample = jax.tree.map(jnp.asarray, to_jax_entry(entries[0]))
    jm = jd.DSGDETR(mode="sgcls", feat_dim=FEAT)
    variables = jax.jit(lambda key, e, g: jm.init(key, e, train=False, group_id=g))(
        jax.random.key(1), sample, jnp.asarray(gid[0].numpy()))
    variables = perturbed(variables, 9)
    params, stats = jax.tree.map(jnp.asarray, (variables["params"], variables["batch_stats"]))
    keys = HEADS + ("distribution",)
    batch = stack_entries(entries)
    model = td.DSGDETR(mode="sgcls", feat_dim=FEAT, dropout=0.0, device="cpu")
    model.load_state_dict(dsg_detr_from_jax(params, stats))
    ours = model(batch, train=True, group_id=gid, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    weights = {k: rng.standard_normal(ours[k].shape).astype(np.float32) for k in keys}
    sum(((ours[k] * torch.from_numpy(weights[k])).sum() for k in keys)).backward()

    def loss(p):
        def per_video(entry, g):
            return jm.apply({"params": p, "batch_stats": stats}, entry, train=True, group_id=g,
                            mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})[0]
        pred = jax.vmap(per_video)(jbatch(entries), jnp.asarray(gid.numpy()))
        return sum((pred[k] * weights[k]).sum() for k in keys), pred

    grads, ref = jax.device_get(jax.jit(jax.grad(loss, has_aux=True))(params))
    check(ours, ref, keys)
    ref_grads = {n: g.numpy() for n, g in dsg_detr_from_jax(grads, stats).items()
                 if n.startswith("object_classifier.") and g.is_floating_point()}
    got = {n: p.grad for n, p in model.named_parameters() if n.startswith("object_classifier.")}
    assert got.keys() <= ref_grads.keys() and len(got) == 5 + 3 * 12 + 6
    scale = max(float(np.abs(g).max()) for g in ref_grads.values())
    assert scale > 0
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[n], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=n)


def test_weight_round_trips():
    """port state_dict -> convert_dsg_detr -> dsg_detr_from_jax gives it
    back; JAX params -> dsg_detr_from_jax -> convert_dsg_detr gives them
    back (sgdet: the layout with a reference converter)."""
    model = td.DSGDETR(mode="sgdet", feat_dim=64, device="cpu")
    sd = model.state_dict()
    params, stats, unused = convert_ref.convert_dsg_detr(sd)
    assert unused == []
    back = dsg_detr_from_jax(params, stats)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k

    e = make_synthetic_entry(np.random.default_rng(0), n_frames=2, objs_per_frame=2,
                             bucket_boxes=8, bucket_rels=8, feat_dim=64)
    variables = jd.DSGDETR(mode="sgdet", feat_dim=64).init(
        jax.random.key(1), jax.tree.map(jnp.asarray, to_jax_entry(e)))
    p2, s2, unused = convert_ref.convert_dsg_detr(
        dsg_detr_from_jax(variables["params"], variables["batch_stats"]))
    assert unused == []
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path((variables["params"], variables["batch_stats"])),
            jax.tree_util.tree_leaves_with_path((p2, s2)), strict=True):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
