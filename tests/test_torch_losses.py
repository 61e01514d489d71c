"""The port's per-video losses against the JAX package's sttran_losses run
per video under vmap, in BCE and margin modes, on batched synthetic Entries
(bit-identical in both packages from one numpy seed) with random logits.
Padding rows are poisoned with 1e6 logits and must not move any term; a
fill video's terms are exactly 0. The attention-label draw uses each
package's own random stream, so the attention GT here is one-hot (the
synthetic default) and the draw is deterministic; `sample_multi_hot` is
checked for uniformity on its own.

Tolerance 1e-5 relative (float32 on both sides, the same formulas).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.models import losses as jlosses
from nl_vsgg_tpu_torch.data.entry import Entry, empty_entry, stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models import losses as tlosses

NB, NR = 24, 16
HEADS = {"distribution": ("box", 37), "attention_distribution": ("rel", 3),
         "spatial_logits": ("rel", 6), "contacting_logits": ("rel", 17)}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    es = [make_synthetic_entry(rng, n_frames=n, objs_per_frame=2, bucket_boxes=NB,
                               bucket_rels=NR, feat_dim=8) for n in (5, 3)]
    # a valid row whose only spatial GT is predicate 0: margin mode leaves it out
    first = int(np.nonzero(es[0].rel_mask.numpy())[0][0])
    es[0].spatial_gt[first] = 0.0
    es[0].spatial_gt[first, 0] = 1.0
    return stack_entries(es + [empty_entry(NB, NR, 8)])


def fake_pred(rng):
    return {key: rng.standard_normal((3, NB if kind == "box" else NR, c)).astype(np.float32)
            for key, (kind, c) in HEADS.items()}


def jax_losses(pred, e: Entry, bce):
    je = jentry.Entry(**{f.name: jnp.asarray(getattr(e, f.name).numpy())
                         for f in dataclasses.fields(Entry)})
    fn = jax.vmap(lambda p, en, k: jlosses.sttran_losses(p, en, k, bce=bce))
    out = fn({k: jnp.asarray(v) for k, v in pred.items()}, je,
             jax.random.split(jax.random.key(0), 3))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("bce", [True, False])
def test_losses_match_jax_per_video(bce):
    e = batch()
    pred = fake_pred(np.random.default_rng(1))
    ours = tlosses.sttran_losses({k: torch.from_numpy(v) for k, v in pred.items()}, e,
                                 torch.Generator().manual_seed(0), bce=bce)
    ref = jax_losses(pred, e, bce)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == (3,), k
        np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert ours[k][2] == 0.0, k  # the fill video
    assert (ours["total"][:2] > 0).all()


@pytest.mark.parametrize("bce", [True, False])
def test_padding_rows_do_not_contribute(bce):
    e = batch(seed=2)
    rng = np.random.default_rng(3)
    pred = fake_pred(rng)
    poisoned = {k: v.copy() for k, v in pred.items()}
    for key, (kind, _) in HEADS.items():
        mask = (e.box_mask if kind == "box" else e.rel_mask).numpy()
        poisoned[key][~mask] = 1e6
    a, b = (tlosses.sttran_losses({k: torch.from_numpy(v) for k, v in p.items()}, e,
                                  torch.Generator().manual_seed(0), bce=bce)
            for p in (pred, poisoned))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=0)


def test_margin_mode_excludes_predicate0_only_rows():
    e = batch()
    pred = {k: torch.from_numpy(v) for k, v in fake_pred(np.random.default_rng(4)).items()}
    first = int(np.nonzero(e.rel_mask[0].numpy())[0][0])
    out = tlosses.sttran_losses(pred, e, torch.Generator().manual_seed(0), bce=False)
    moved = {k: v.clone() for k, v in pred.items()}
    moved["spatial_logits"][0, first] += 100.0
    out2 = tlosses.sttran_losses(moved, e, torch.Generator().manual_seed(0), bce=False)
    assert out["spatial_relation_loss"][0] == out2["spatial_relation_loss"][0]
    out3 = tlosses.sttran_losses(moved, e, torch.Generator().manual_seed(0), bce=True)
    out4 = tlosses.sttran_losses(pred, e, torch.Generator().manual_seed(0), bce=True)
    assert out3["spatial_relation_loss"][0] != out4["spatial_relation_loss"][0]


def test_sample_multi_hot_uniform_among_positives():
    mh = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).repeat(2000, 1, 1)
    draws = tlosses.sample_multi_hot(mh, torch.Generator().manual_seed(0))
    first = draws[:, 0]
    assert set(first.tolist()) == {0, 2}
    assert abs(float((first == 0).float().mean()) - 0.5) < 5 * np.sqrt(0.25 / 2000)
    assert (draws[:, 1] == 0).all() and (draws[:, 2] == 1).all()
