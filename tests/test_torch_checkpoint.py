"""The port's checkpoints (utils/checkpoint.py): a TrainState after a few
train steps round-trips exactly (the model's parameters and BatchNorm
buffers, AdamW's moments, step counts and lr, `step`, `skipped`), into a
fresh state the training tool would build; the directory layout the JAX
package writes (<dir>/<step>, <step>.meta.json, configs.json) and its
`keep` pruning; `latest_step` / `load_meta` on a missing directory; and a
save killed before its rename leaves the previous checkpoint readable."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries
from nl_vsgg_tpu_torch.utils import checkpoint as ck

FEAT = 32


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of these models is a few hundred MB: none is kept."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _state(seed: int, steps: int):
    model = STTran(feat_dim=FEAT, dec_layer_num=1, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    st = create_train_state(model, lr=1e-3)
    rng = np.random.default_rng(seed)
    batch = place_entries([make_synthetic_entry(rng, n_frames=3, objs_per_frame=2,
                                                bucket_boxes=12, bucket_rels=8, feat_dim=FEAT)
                           for _ in range(2)], device="cpu")
    step = make_train_step(model, st.optimizer)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        st, _ = step(st, batch, gen)
    st.skipped = 3  # a count the step would keep
    return st


def _same_state(a, b) -> None:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.adamw.state_dict(), b.optimizer.adamw.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for i, s in oa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], ob["state"][i][k]), (i, k)
    assert (a.step, a.skipped) == (b.step, b.skipped)


def test_round_trip_restores_the_whole_state(tmp_path):
    st = _state(0, 2)
    st.optimizer.param_groups[0]["lr"] = 2.5e-4  # a scheduler's decay
    path = ck.save_checkpoint(str(tmp_path / "ckpt"), 4, st, config_json='{"seed": 1}',
                              extra={"scheduler": {"lr": 2.5e-4, "best": 0.5, "num_bad": 1}})
    assert path == str(tmp_path / "ckpt" / "4")
    fresh = _state(1, 0)  # other weights, no moments yet
    out = ck.restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert out is fresh
    _same_state(fresh, st)
    assert ck.load_meta(str(tmp_path / "ckpt"))["scheduler"]["num_bad"] == 1
    assert json.load(open(tmp_path / "ckpt" / "configs.json")) == {"seed": 1}
    # the restored state trains on exactly as the saved one does
    rng = np.random.default_rng(5)
    batch = place_entries([make_synthetic_entry(rng, n_frames=3, objs_per_frame=2,
                                                bucket_boxes=12, bucket_rels=8, feat_dim=FEAT)
                           for _ in range(2)], device="cpu")
    outs = []
    for s in (st, fresh):
        s2, m = make_train_step(s.model, s.optimizer)(s, batch, torch.Generator().manual_seed(9))
        outs.append((s2, float(m["total"])))
    assert outs[0][1] == outs[1][1]
    _same_state(outs[0][0], outs[1][0])


def test_keep_prunes_old_steps_and_their_sidecars(tmp_path):
    st = _state(0, 0)
    d = str(tmp_path / "ckpt")
    for step in range(5):
        ck.save_checkpoint(d, step, st, keep=2, extra={"step": step})
    assert sorted(os.listdir(d)) == ["3", "3.meta.json", "4", "4.meta.json"]
    assert ck.latest_step(d) == 4 and ck.load_meta(d, 3) == {"step": 3}
    ck.save_checkpoint(d, 4, st, keep=2)  # a re-save of the newest step
    assert ck.latest_step(d) == 4 and ck.load_state(d)["step"] == 0


def test_missing_directory(tmp_path):
    d = str(tmp_path / "none")
    assert ck.latest_step(d) is None and ck.load_meta(d) is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ck.restore_checkpoint(d, _state(0, 0))
    ck.save_checkpoint(d, 0, _state(0, 0))
    assert ck.load_meta(d, 0) is None  # saved without a sidecar


def test_killed_save_leaves_the_last_checkpoint_readable(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    first = _state(0, 1)
    ck.save_checkpoint(d, 0, first, extra={"epoch": 0})
    real = os.replace

    def killed(src, dst):
        if os.path.basename(dst) == "1":
            raise KeyboardInterrupt("killed before the rename")
        return real(src, dst)

    monkeypatch.setattr(ck.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.save_checkpoint(d, 1, _state(2, 2), extra={"epoch": 1})
    monkeypatch.setattr(ck.os, "replace", real)
    assert ck.latest_step(d) == 0 and ck.load_meta(d) == {"epoch": 0}
    _same_state(ck.restore_checkpoint(d, _state(3, 0)), first)
    # the next save of that step succeeds over the leftover
    ck.save_checkpoint(d, 1, first)
    assert ck.latest_step(d) == 1


def test_load_model_state_over_the_models_own_keys():
    sgdet = _state(0, 0).model
    predcls = STTran(mode="predcls", feat_dim=FEAT, dec_layer_num=1, device="cpu")
    unused = ck.load_model_state(predcls, sgdet.state_dict())
    assert unused and all(k.startswith("object_classifier.") for k in unused)
    for k, v in predcls.state_dict().items():
        assert torch.equal(v, sgdet.state_dict()[k]), k
    sd = dict(sgdet.state_dict())
    sd.pop("a_rel_compress.bias")
    sd["glocal_transformer.global_attention.layers.5.linear1.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match=r"missing=\['a_rel_compress.bias'\] extra=\['glocal"):
        ck.load_model_state(sgdet, sd)


def test_maskrcnn_layout_round_trip():
    """detector/convert.to_maskrcnn_state_dict is the inverse of
    from_maskrcnn_state_dict (FrozenBN with running stats 0 and 1 folds to
    the same scale and bias), on every key of the detector."""
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNModule
    from nl_vsgg_tpu_torch.detector.convert import from_maskrcnn_state_dict, to_maskrcnn_state_dict
    with torch.device("meta"):
        keys = list(AttrRCNNModule().state_dict())
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(3, generator=g) for k in keys}
    back = from_maskrcnn_state_dict(to_maskrcnn_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
