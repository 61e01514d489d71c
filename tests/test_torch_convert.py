"""Weights across packages, and the port's import isolation.

JAX STTran params -> `sttran_from_jax` -> the port's state_dict (loads
strictly) -> nl_vsgg_tpu/models/convert_ref.py::convert_sttran gives back
the JAX trees exactly. A subprocess with `jax` blocked imports every module
of nl_vsgg_tpu_torch and finds no JAX and no nl_vsgg_tpu module loaded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from nl_vsgg_tpu.data.synthetic import make_synthetic_entry as j_make
from nl_vsgg_tpu.models.convert_ref import convert_sttran
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.sttran import STTran

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT = 32


@pytest.mark.parametrize("dec_layers", [1, 3])
def test_jax_params_round_trip(dec_layers):
    entry = j_make(np.random.default_rng(0), n_frames=2, objs_per_frame=1,
                   bucket_boxes=4, bucket_rels=2, feat_dim=FEAT)
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=dec_layers)
    variables = jax.device_get(jm.init({"params": jax.random.key(0),
                                        "dropout": jax.random.key(1)}, entry))
    # non-trivial running statistics, so a swapped buffer would show
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    sd = sttran_from_jax(variables["params"], stats)

    model = STTran(feat_dim=FEAT, dec_layer_num=dec_layers, device="cpu")
    model.load_state_dict(sd, strict=True)

    params, back_stats, unused = convert_sttran(model.state_dict())
    assert unused == []
    for tree, ref in ((params, variables["params"]), (back_stats, stats)):
        flat = dict(jax.tree_util.tree_leaves_with_path(tree))
        flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
        assert flat.keys() == flat_ref.keys()
        for path, leaf in flat_ref.items():
            np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_state_dict_names_are_the_reference_layout():
    sd = STTran(feat_dim=FEAT, device="cpu").state_dict()
    assert sd["union_func1.weight"].shape == (256, FEAT, 1, 1)
    assert sd["vr_fc.weight"].shape == (512, 256 * 7 * 7)
    p = "glocal_transformer.global_attention.layers.2.multihead2"
    assert sd[p + ".in_proj_weight"].shape == (3 * 1936, 1936)
    assert sd[p + ".out_proj.weight"].shape == (1936, 1936)
    for k in ("object_classifier.pos_embed.0.running_var",
              "object_classifier.decoder_lin.3.weight", "conv.6.running_mean",
              "glocal_transformer.local_attention.layers.0.self_attn.in_proj_bias",
              "glocal_transformer.position_embedding.weight"):
        assert k in sd, k


def test_port_imports_without_jax():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["flax"] = None
import nl_vsgg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nl_vsgg_tpu_torch.__path__, "nl_vsgg_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "nl_vsgg_tpu" or m.startswith(("nl_vsgg_tpu.", "jax.", "flax.", "optax")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 12, names
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
