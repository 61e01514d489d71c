"""The port's sharded forwards (nl_vsgg_tpu_torch/parallel/sequence.py,
sttran_sp.py, dsg_detr_sp.py) in 2 and 4 gloo ranks on the CPU
(tests/_torch_dist_worker.py), against the port's dense modules on the same
weights and against the JAX package's sharded functions over a mesh of as
many CPU devices, on the shapes of tests/test_sequence_parallel.py,
test_sttran_sp.py and test_dsg_detr_sp.py.

Weights come from the JAX side (`init` and the key maps of
models/convert), and the port's LayerNorms take flax's eps (1e-6), so the
two packages compute the same function. Tolerances:
- sharded against dense, port: the same layers on the same rows, only the
  attention's key set split and re-joined -> 1e-5 absolute (float32);
- port against JAX: float32 in another operation order through up to 3
  layers and a softmax -> 1e-4 absolute and relative (5e-4 for DSG-DETR's
  1936-wide layers, whose sums run over 1936 products).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.data.entry import Entry as JEntry
from nl_vsgg_tpu.models.convert_ref import convert_dsg_detr
from nl_vsgg_tpu.models.dsg_detr import DSGDETR as JDSGDETR
from nl_vsgg_tpu.models.sttran import STTranTransformer as JTransformer
from nl_vsgg_tpu.parallel.dsg_detr_sp import dsg_detr_transformer_sharded as j_dsg_sharded
from nl_vsgg_tpu.parallel.mesh import make_mesh as j_make_mesh
from nl_vsgg_tpu.parallel.sequence import windowed_attention_sharded as j_seq_sharded
from nl_vsgg_tpu.parallel.sttran_sp import grid_to_rel as j_grid_to_rel
from nl_vsgg_tpu.parallel.sttran_sp import rel_to_grid as j_rel_to_grid
from nl_vsgg_tpu.parallel.sttran_sp import sttran_transformer_sharded as j_sttran_sharded
from nl_vsgg_tpu_torch.data.entry import stack_entries
from nl_vsgg_tpu_torch.models import convert
from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
from nl_vsgg_tpu_torch.models.sttran import STTranTransformer
from nl_vsgg_tpu_torch.parallel.sequence import windowed_attention_reference
from nl_vsgg_tpu_torch.parallel.sttran_sp import grid_to_rel, rel_to_grid
from tests._torch_dist_worker import run_job

D, HEADS, FF = 64, 4, 128                   # tests/test_sttran_sp.py
F_MAX, SLOTS = 8, 12
SEQ_F, SEQ_L, SEQ_D = 16, 4, 32             # tests/test_sequence_parallel.py
FRAME_CASES = (8, 5, 1)                     # video lengths; 1: no window at all
SHARD_ATOL = 1e-5
JAX_TOL = 1e-4
DSG_TOL = 5e-4


def _tokens(rng, R=48, n_frames=8):
    im_idx = np.sort(rng.integers(0, n_frames, R)).astype(np.int32)
    rel_mask = rng.uniform(size=R) > 0.2
    im_idx = np.where(rel_mask, im_idx, 0).astype(np.int32)
    feats = rng.standard_normal((R, D)).astype(np.float32)
    feats[~rel_mask] = 0.0
    return feats, im_idx, rel_mask


def flax_eps(module):
    for m in module.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = 1e-6
    return module


def _transformer_from_jax(tr) -> STTranTransformer:
    sd = {"position_embedding.weight": convert._t(tr["position_embedding"])}
    for i in range(1):
        convert._encoder_layer(sd, f"local_attention.layers.{i}", tr[f"enc_{i}"])
    for i in range(2):
        p, lay = f"global_attention.layers.{i}", tr[f"dec_{i}"]
        convert._mha(sd, p + ".multihead2", lay["multihead2"])
        for n in ("linear1", "linear2"):
            convert._lin(sd, f"{p}.{n}", lay[n])
        convert._ln(sd, p + ".norm3", lay["norm3"])
    m = STTranTransformer(embed_dim=D, num_heads=HEADS, dim_feedforward=FF, enc_layers=1,
                          dec_layers=2, dropout=0.0)
    m.load_state_dict(sd)
    return flax_eps(m.eval())


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    # ---- the windowed attention demo ----
    tokens = rng.standard_normal((SEQ_F, SEQ_L, SEQ_D)).astype(np.float32)
    valid = rng.uniform(size=(SEQ_F, SEQ_L)) > 0.3
    valid[5] = False
    params = {k: {"kernel": rng.standard_normal((SEQ_D, SEQ_D)).astype(np.float32) * 0.1,
                  "bias": np.zeros(SEQ_D, np.float32)} for k in "qkvo"}
    pos = rng.standard_normal((2, SEQ_D)).astype(np.float32) * 0.1
    tparams = {k: {n: torch.tensor(a) for n, a in v.items()} for k, v in params.items()}
    seq = {"tokens": torch.tensor(tokens), "valid": torch.tensor(valid), "params": tparams,
           "pos": torch.tensor(pos), "heads": 4}
    seq_np = (tokens, valid, params, pos)

    # ---- STTran's transformer, weights from the flax module ----
    cases = [_tokens(rng, n_frames=f) for f in FRAME_CASES]
    jt = JTransformer(embed_dim=D, num_heads=HEADS, dim_feedforward=FF, enc_layers=1,
                      dec_layers=2, mode="latter")
    f0, i0, m0 = cases[0]
    jvars = jt.init(jax.random.key(0), jnp.asarray(f0), jnp.asarray(i0), jnp.asarray(m0),
                    jnp.int32(8))
    module = _transformer_from_jax(jvars["params"])
    st_cases = [(torch.tensor(f), torch.tensor(i), torch.tensor(m), F_MAX,
                 SLOTS if n > 1 else f.shape[0]) for (f, i, m), n in zip(cases, FRAME_CASES)]

    # ---- DSG-DETR, 1 local + 1 global layer at feat 64 ----
    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry

    e = make_synthetic_entry(np.random.default_rng(3), n_frames=4, objs_per_frame=2,
                             bucket_boxes=24, bucket_rels=32, feat_dim=64)
    dsg = flax_eps(DSGDETR(mode="sgdet", feat_dim=64, enc_layer_num=1, dec_layer_num=1,
                           dropout=0.0, device="cpu", generator=torch.Generator().manual_seed(4)))
    batch = stack_entries([e])
    with torch.no_grad():
        h, fo, oc, rk = dsg.segment_inputs(batch)
        dense_dsg = dsg(batch)["global_output"][0]
    dsg_inputs = (h[0].float(), fo[0], oc[0], rk[0], batch.rel_mask[0])
    payload = {"seq": seq, "sttran": {"module": module, "cases": st_cases},
               "dsg": {"model": dsg, "inputs": dsg_inputs}}
    return {"payload": payload, "seq_np": seq_np, "cases": cases, "jt": jt, "jvars": jvars,
            "dsg": dsg, "dense_dsg": dense_dsg, "entry": e, "jobs": {}}


@pytest.fixture(scope="module", params=[2, 4])
def job(request, setup, tmp_path_factory):
    world = request.param
    res = run_job("sp", tmp_path_factory.mktemp(f"sp{world}"), world, setup["payload"])
    return world, res


def test_grid_roundtrip_matches_jax():
    feats, im_idx, rel_mask = _tokens(np.random.default_rng(1))
    grid, valid, gather = rel_to_grid(torch.tensor(feats), torch.tensor(im_idx),
                                      torch.tensor(rel_mask), F_MAX, SLOTS)
    jgrid, jvalid, jgather = j_rel_to_grid(jnp.asarray(feats), jnp.asarray(im_idx),
                                           jnp.asarray(rel_mask), F_MAX, SLOTS)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    for a, b in zip(gather, jgather):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = grid_to_rel(grid, gather, torch.tensor(rel_mask))
    np.testing.assert_array_equal(back.numpy(), feats)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_grid_to_rel(jgrid, jgather,
                                                                         jnp.asarray(rel_mask))))
    with pytest.raises(ValueError, match="slots"):
        rel_to_grid(torch.tensor(feats), torch.tensor(im_idx), torch.tensor(rel_mask), F_MAX, 2)


def test_sequence_sharded_matches_dense_and_jax(job, setup):
    world, res = job
    seq = setup["payload"]["seq"]
    got = torch.cat([r["seq"] for r in res]).numpy()
    dense = windowed_attention_reference(seq["tokens"], seq["valid"], seq["params"],
                                         seq["pos"], 4).numpy()
    np.testing.assert_allclose(got, dense, atol=SHARD_ATOL, rtol=0)
    tokens, valid, params, pos = setup["seq_np"]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]).reshape(world, 1),
                             ("data", "model"))
    ref = jax.jit(lambda *a: j_seq_sharded(mesh)(*a, num_heads=4))(  # one compile
        jnp.asarray(tokens), jnp.asarray(valid), jax.tree.map(jnp.asarray, params),
        jnp.asarray(pos))
    np.testing.assert_allclose(got, np.asarray(ref), atol=JAX_TOL, rtol=JAX_TOL)
    assert all(r["backend"] == "gloo" and r["staged"] == 0 for r in res)  # CPU: no staging


@pytest.mark.parametrize("case", range(len(FRAME_CASES)))
def test_sttran_frame_sharded_matches_dense_and_jax(job, setup, case):
    world, res = job
    module = setup["payload"]["sttran"]["module"]
    feats, im_idx, rel_mask, fmax, slots = setup["payload"]["sttran"]["cases"][case]
    for r in res[1:]:  # every rank returns the whole output
        assert torch.equal(r["sttran"][case], res[0]["sttran"][case])
    got = res[0]["sttran"][case].numpy()
    with torch.no_grad():
        dense = module(feats[None], im_idx[None], rel_mask[None])[0].numpy()
    np.testing.assert_allclose(got, dense, atol=SHARD_ATOL, rtol=0)
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    f, i, m = (jnp.asarray(a) for a in setup["cases"][case])
    with mesh:
        ref = jax.jit(lambda p, f, i, m: j_sttran_sharded(
            mesh, p, f, i, m, jnp.int32(FRAME_CASES[case]), n_frames_max=fmax, slots=slots,
            num_heads=HEADS, enc_layers=1, dec_layers=2))(setup["jvars"]["params"], f, i, m)
    np.testing.assert_allclose(got, np.asarray(ref), atol=JAX_TOL, rtol=JAX_TOL)


def test_dsg_detr_token_sharded_matches_dense_and_jax(job, setup):
    world, res = job
    got = res[0]["dsg"]
    for r in res[1:]:
        assert torch.equal(r["dsg"], got)
    np.testing.assert_allclose(got.numpy(), setup["dense_dsg"].numpy(), atol=SHARD_ATOL * 10,
                               rtol=0)
    # the JAX model on the port's weights, its own segment inputs (taps)
    params, stats, _ = convert_dsg_detr(setup["dsg"].state_dict())
    e = setup["entry"]
    je = JEntry(**{k: v.numpy() for k, v in vars(e).items()})
    jm = JDSGDETR(mode="sgdet", feat_dim=64, enc_layer_num=1, dec_layer_num=1)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    _, inter = jax.jit(lambda v, e: jm.apply(v, e, train=False, mutable=["intermediates"]))(
        variables, je)
    taps = inter["intermediates"]
    mesh = j_make_mesh(data=world, model=1, devices=jax.devices()[:world])
    with mesh:
        ref = jax.jit(lambda p, *a: j_dsg_sharded(mesh, p, *a, enc_layers=1, dec_layers=1))(
            variables["params"], taps["rel_features"][0].astype(jnp.float32),
            taps["frame_of"][0].astype(jnp.int32), taps["obj_cls"][0].astype(jnp.int32),
            taps["ranks"][0].astype(jnp.int32), jnp.asarray(e.rel_mask.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DSG_TOL, rtol=DSG_TOL)


def test_sharded_forwards_refuse_bad_shapes(setup):
    from nl_vsgg_tpu_torch.parallel.dsg_detr_sp import dsg_detr_transformer_sharded
    from nl_vsgg_tpu_torch.parallel.sequence import windowed_attention_sharded
    from nl_vsgg_tpu_torch.parallel.sttran_sp import sttran_transformer_sharded

    seq = setup["payload"]["seq"]
    with pytest.raises(ValueError, match="2 frames"):
        windowed_attention_sharded(seq["tokens"][:1], seq["valid"][:1], seq["params"],
                                   seq["pos"], 4)
    module = setup["payload"]["sttran"]["module"]
    module.mode = "both"
    try:
        with pytest.raises(ValueError, match="latter"):
            sttran_transformer_sharded(module, *setup["payload"]["sttran"]["cases"][0])
    finally:
        module.mode = "latter"
    h, fo, oc, rk, m = setup["payload"]["dsg"]["inputs"]
    out = dsg_detr_transformer_sharded(setup["dsg"], h, fo, oc, rk, m)  # one rank: dense
    np.testing.assert_allclose(out.numpy(), setup["dense_dsg"].numpy(), atol=SHARD_ATOL * 10)
