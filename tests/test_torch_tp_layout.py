"""The model axis's layout (nl_vsgg_tpu_torch/parallel/tensor.py) against
the JAX package's `nl_vsgg_tpu.parallel.mesh.param_shardings`, in one
process: the weights the port shards are the kernels JAX marks P(None,
'model'), for STTran and DSG-DETR sgdet and sgcls (its tracklet encoder at
feat 704, width 1032, sharded too), each bias going with its columns; each
rank's slice equals the JAX array's shard at its model index (weights
carried across with models/convert; no tolerance). The trees come from
`jax.eval_shape` and are filled with seeded values. A width the model axis
does not divide is refused; a sharded model needs the optimizer that
`create_train_state` builds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.models.dsg_detr import DSGDETR as JDSGDETR
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.parallel.mesh import _param_spec
from nl_vsgg_tpu.parallel.mesh import make_mesh as j_make_mesh
from nl_vsgg_tpu.parallel.mesh import param_shardings
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.convert import dsg_detr_from_jax, sttran_from_jax
from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.parallel import tensor as T
from nl_vsgg_tpu_torch.parallel.mesh import Mesh
from nl_vsgg_tpu_torch.train.step import make_train_step
from tests.test_torch_sttran import to_jax_entry
from tests.test_torch_tp import FEAT, NB, NR

SGCLS_FEAT = 704


def _indicator(params):
    """1 where JAX's rule shards a kernel (P(None, 'model')), 0 elsewhere."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(np.shape(leaf), float(len(_param_spec(path, leaf)) == 2),
                                   np.float32), params)


def _jax_models():
    e = to_jax_entry(make_synthetic_entry(np.random.default_rng(5), n_frames=4,
                                          objs_per_frame=2, bucket_boxes=NB, bucket_rels=NR,
                                          feat_dim=FEAT))
    e = jax.tree.map(jnp.asarray, e)
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
    rng = np.random.default_rng(11)
    out = {}
    for name, jm, conv, port in (
            ("sttran", JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1), sttran_from_jax,
             lambda: STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")),
            ("dsg sgdet", JDSGDETR(mode="sgdet", feat_dim=FEAT, dec_layer_num=1),
             dsg_detr_from_jax,
             lambda: DSGDETR(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")),
            # the tracklet encoder's width feat + 328 = 1032: sharded too
            ("dsg sgcls", JDSGDETR(mode="sgcls", feat_dim=SGCLS_FEAT, dec_layer_num=1),
             dsg_detr_from_jax,
             lambda: DSGDETR(mode="sgcls", feat_dim=SGCLS_FEAT, dec_layer_num=1,
                             device="cpu"))):
        fe = e if name != "dsg sgcls" else jax.tree.map(
            jnp.asarray, to_jax_entry(make_synthetic_entry(
                np.random.default_rng(1), n_frames=2, objs_per_frame=2, bucket_boxes=8,
                bucket_rels=4, feat_dim=SGCLS_FEAT)))
        # the trees' shapes by tracing alone, filled with seeded values
        shapes = jax.eval_shape(functools.partial(jm.init, train=False), rngs, fe)
        v = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
        out[name] = (v["params"], v["batch_stats"], conv, port)
    return out


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


@pytest.mark.parametrize("name", ["sttran", "dsg sgdet", "dsg sgcls"])
def test_port_shards_what_jax_shards(jax_models, name):
    params, stats, conv, build = jax_models[name]
    marks = conv(_indicator(params), stats)
    want = {k for k, v in marks.items() if k.endswith("weight") and bool((v == 1).any())}
    assert all(bool((marks[k] == 1).all()) for k in want)   # whole tensors, every q/k/v block
    port = build()
    T.shard_module(port, Mesh(1, 2, 0, torch.device("cpu"), 0, 0))
    got = {k for k in T.shard_specs(port) if k.endswith("weight")}
    assert got == want and len(got) >= 5
    # every bias of a sharded weight goes with its columns, and nothing else
    assert set(T.shard_specs(port)) == got | {k[:-len("weight")] + "bias" for k in got}


@pytest.mark.parametrize("name", ["sttran", "dsg sgcls"])
def test_each_rank_holds_the_jax_shard_of_its_model_index(jax_models, name):
    params, stats, conv, build = jax_models[name]
    mesh = j_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    placed = jax.tree.map(jax.device_put, params, param_shardings(mesh, params))
    full = conv(jax.device_get(params), jax.device_get(stats))
    for r in range(2):
        dev = mesh.devices[0, r]

        def shard(leaf):
            if len(leaf.sharding.spec) == 2:  # P(None, 'model'): rank r's columns
                return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev)
            return np.asarray(leaf)
        want = conv(jax.tree.map(shard, placed), jax.device_get(stats))
        port = build()
        port.load_state_dict(full, strict=True)
        T.shard_module(port, Mesh(1, 2, r, torch.device("cpu"), 0, r))
        sd = port.state_dict()
        tp = T.TP(None, r, 2)
        for k, (_, blocks) in T.shard_specs(port).items():
            if k.endswith("weight"):
                assert torch.equal(sd[k], want[k]), k
            else:   # the bias's columns of the JAX shard: the full bias sliced alike
                assert torch.equal(sd[k], T.take_shard(full[k], tp, blocks)), k
        for k in set(sd) - set(T.shard_specs(port)):
            assert torch.equal(sd[k], full[k]), k


def test_a_width_the_model_axis_does_not_divide_is_refused():
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")
    with pytest.raises(ValueError, match=r"mesh model=3 does not divide .*\[1024, 1936, 2048\]"):
        T.shard_module(model, Mesh(1, 3, 0, torch.device("cpu"), 0, 0))
    assert T.model_axis(model) is None                       # nothing sliced
    assert T.shard_module(model, Mesh(1, 1, 0, torch.device("cpu"))) is model
    assert T.model_axis(model) is None


def test_sharded_model_needs_its_optimizer_from_create_train_state():
    from nl_vsgg_tpu_torch.train.state import make_optimizer

    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")
    T.shard_module(model, Mesh(1, 2, 0, torch.device("cpu"), 0, 0))
    with pytest.raises(ValueError, match="create_train_state"):
        make_train_step(model, make_optimizer(model.parameters()))
