"""The port's offline label pipeline (`nl_vsgg_tpu_torch.pipelines`) against
the JAX package's (`nl_vsgg_tpu.pipelines`) on the CPU: the prompts, the
tokenizer, CLIP (a residual block at a narrow width, the LoRA merge, the
converters and both towers at ViT-B/32's full width, `encode_for_adv`),
the ADV alignment with the port's numpy KMeans, the triplet bookkeeping,
negatives and the TCS / triplet parsers. Inputs are seeded numpy.

Tolerances, each with its reason:
  * prompts, tokenizer ids, KMeans labels and centers (against sklearn),
    ADV / negatives / parser outputs, converted weights: exact (the same
    numpy arithmetic in the same order);
  * CLIP with the JAX package's LayerNorm eps (1e-6, set on the port's
    modules for the comparison): a residual block at width 64 within 1e-5;
    the full towers' unit embeddings within 1e-4, the raw ones within
    1e-4 x max|ref| (float32 in another summation order through 12
    layers);
  * CLIP with the port's own eps (1e-5, open_clip's and the DAC
    reference's): the block within 1e-5 x max|ref|; the towers' unit
    embeddings within 2e-3 — with embeddings at 0.02 scale the first
    LayerNorm's rows have a variance near 1e-3, where the two eps differ
    by about 1% of it (4.9e-4 measured on these weights).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.pipelines import adv as jadv
from nl_vsgg_tpu.pipelines import clip_jax as J
from nl_vsgg_tpu.pipelines import negatives as jneg
from nl_vsgg_tpu.pipelines import prompts as jprompts
from nl_vsgg_tpu.pipelines import tcs as jtcs
from nl_vsgg_tpu.pipelines import tokenizer as jtok
from nl_vsgg_tpu.pipelines import triplets as jtri
from nl_vsgg_tpu_torch.data import schema
from nl_vsgg_tpu_torch.pipelines import adv, negatives, prompts, tcs, tokenizer, triplets
from nl_vsgg_tpu_torch.pipelines import clip as C

MERGES = [("t", "h"), ("th", "e</w>"), ("e", "r"), ("er", "</w>"),
          ("p", "er"), ("per", "s"), ("pers", "o"), ("perso", "n</w>")]
BLOCK_TOL = 1e-5
UNIT_TOL = 1e-4
EPS_UNIT_TOL = 2e-3


def same(a, b) -> bool:
    """Deep equality of nested lists / tuples / dicts / numpy arrays / torch
    tensors, types and dtypes included; a list of tuples (a frame's
    triplets, made from a set) compares in sorted order."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return type(a) is type(b) and a.dtype == b.dtype and bool(torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
                and bool(np.array_equal(a, b)))
    if isinstance(a, dict):
        return type(a) is type(b) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list) and a and b and \
            all(isinstance(x, tuple) for x in a + b):
        return sorted(a) == sorted(b)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def flax_eps(*modules) -> None:
    """Set every LayerNorm of `modules` to flax's eps, the JAX package's."""
    for m in modules:
        for ln in m.modules():
            if isinstance(ln, torch.nn.LayerNorm):
                ln.eps = 1e-6


# ------------------------------------------------------------ prompts, BPE
def test_prompts_byte_equal():
    for name in ("TCS_PROMPT", "TRIPLET_PROMPT_HEADER"):
        assert getattr(prompts, name).encode() == getattr(jprompts, name).encode()
    assert tcs.TCS_PROMPT is prompts.TCS_PROMPT
    assert triplets.build_prompt(["a b", "c"]) == jtri.build_prompt(["a b", "c"])


@pytest.mark.parametrize("texts", [
    ["The person!", "the"],
    ["THE   PERSON", "  the\tperson\n ", "person's  thing"],
    ["café au lait", "naïve person!", "a_b 12", "ÉCOLE", "日本 person"],
    [" ".join(["qq"] * 200), " ".join(["person"] * 80)],
    ["&amp;lt;the&gt;", "<|startoftext|> the <|endoftext|>"],
])
def test_tokenizer_ids_equal(texts):
    port, ref = tokenizer.SimpleTokenizer(merges=MERGES), jtok.SimpleTokenizer(merges=MERGES)
    got, want = port.tokenize(texts), ref.tokenize(texts)
    assert got.dtype == want.dtype and got.shape == want.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    assert port.encoder == ref.encoder and port.bpe_ranks == ref.bpe_ranks
    # every row ends in EOT, the vocabulary's largest id (the text tower
    # pools at a row's argmax)
    assert port.eot == max(port.encoder.values())
    assert all(row[row != 0][-1] == port.eot for row in got)
    assert tokenizer.bytes_to_unicode() == jtok.bytes_to_unicode()


def test_tokenizer_reads_a_vocab_file(tmp_path):
    path = tmp_path / "bpe.txt"
    path.write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    port = tokenizer.SimpleTokenizer(str(path))
    np.testing.assert_array_equal(port.tokenize("the person"),
                                  jtok.SimpleTokenizer(str(path)).tokenize("the person"))


# ------------------------------------------------------------------- CLIP
def _block_sd(rng, w, prefix):
    def lin(o, i, s=0.1):
        return (rng.standard_normal((o, i)) * s).astype(np.float32)

    sd = {prefix + ".attn.in_proj_weight": lin(3 * w, w),
          prefix + ".attn.in_proj_bias": lin(1, 3 * w)[0],
          prefix + ".attn.out_proj.weight": lin(w, w), prefix + ".attn.out_proj.bias": lin(1, w)[0],
          prefix + ".mlp.c_fc.weight": lin(4 * w, w), prefix + ".mlp.c_fc.bias": lin(1, 4 * w)[0],
          prefix + ".mlp.c_proj.weight": lin(w, 4 * w), prefix + ".mlp.c_proj.bias": lin(1, w)[0]}
    for ln in ("ln_1", "ln_2"):
        sd[f"{prefix}.{ln}.weight"] = 1 + lin(1, w)[0]
        sd[f"{prefix}.{ln}.bias"] = lin(1, w)[0]
    return sd


@pytest.mark.parametrize("causal", [False, True])
def test_residual_block_matches_jax(causal):
    W, H, L = 64, 4, 9
    rng = np.random.default_rng(5)
    sd = _block_sd(rng, W, "blk")
    x = rng.standard_normal((2, L, W)).astype(np.float32)
    ref = np.asarray(J.ResidualBlock(W, H, causal=causal).apply(
        {"params": J._block_params(sd, "blk", W, 1.0)}, jnp.asarray(x)))
    block = C.ResidualBlock(W, H)
    block.load_state_dict({k[4:]: torch.from_numpy(v) for k, v in sd.items()})
    allow = C.allow_mask(2, L, causal, "cpu")
    with torch.no_grad():
        own = block(torch.from_numpy(x), allow).numpy()
        flax_eps(block)
        got = block(torch.from_numpy(x), allow).numpy()
    assert np.abs(got - ref).max() <= BLOCK_TOL
    assert np.abs(own - ref).max() <= BLOCK_TOL * np.abs(ref).max()


@pytest.mark.parametrize("spelling", ["stem", "stem.weight", "in_proj"])
def test_merge_lora_spellings(spelling):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((12, 8)).astype(np.float32)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((12, 4)).astype(np.float32)
    if spelling == "in_proj":
        key, sd = "m.attn.in_proj_weight", {"m.attn.in_proj.lora_A": a, "m.attn.in_proj.lora_B": b}
    elif spelling == "stem":
        key, sd = "m.fc.weight", {"m.fc.lora_A": a, "m.fc.lora_B": b}
    else:
        key, sd = "m.fc.weight", {"m.fc.lora_A.weight": a, "m.fc.lora_B.weight": b}
    sd[key] = w
    assert C._lora_key_pairs(key) == J._lora_key_pairs(key)
    got = C._merge_lora({k: torch.from_numpy(v) for k, v in sd.items()}, key, 0.5)
    np.testing.assert_array_equal(got, J._merge_lora(sd, key, 0.5))
    np.testing.assert_array_equal(got, w + 0.5 * (b @ a))
    # an adapter under a name no weight resolves is consumed by neither
    # side: the merge leaves the weight as it is (validate_checkpoint
    # refuses such a file, tests/test_torch_preprocess.py)
    orphan = {"m.fc.weight": w, "m.fcx.lora_A": a, "m.fcx.lora_B": b}
    np.testing.assert_array_equal(C._merge_lora(orphan, "m.fc.weight"), w)
    np.testing.assert_array_equal(J._merge_lora(orphan, "m.fc.weight"), w)


def dac_state_dict(rng) -> dict:
    """A synthetic DAC LLM_cp.pt state dict at ViT-B/32's full width:
    open_clip keys, embeddings at 0.02 scale, LayerNorm scales near 1, and
    rank-4 LoRA adapters in all three spellings on every block."""
    def lin(o, i, s=0.02):
        return (rng.standard_normal((o, i)) * s).astype(np.float32)

    sd = {"visual.conv1.weight": (rng.standard_normal(
              (C.VISION_WIDTH, 3, C.PATCH, C.PATCH)) * 0.02).astype(np.float32),
          "visual.class_embedding": lin(1, C.VISION_WIDTH)[0],
          "visual.positional_embedding": lin(50, C.VISION_WIDTH),
          "visual.proj": lin(C.VISION_WIDTH, C.EMBED_DIM),
          "token_embedding.weight": lin(C.VOCAB, C.TEXT_WIDTH),
          "positional_embedding": lin(C.CONTEXT, C.TEXT_WIDTH),
          "text_projection": lin(C.TEXT_WIDTH, C.EMBED_DIM),
          "logit_scale": np.float32(4.6)}
    for key in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        w = C.VISION_WIDTH if key.startswith("visual") else C.TEXT_WIDTH
        sd[key + ".weight"] = 1 + lin(1, w, 0.1)[0]
        sd[key + ".bias"] = lin(1, w, 0.1)[0]

    def block(p, w):
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = 1 + lin(1, w, 0.1)[0]
            sd[f"{p}.{ln}.bias"] = lin(1, w, 0.1)[0]
        sd[p + ".attn.in_proj_weight"] = lin(3 * w, w)
        sd[p + ".attn.in_proj_bias"] = lin(1, 3 * w)[0]
        sd[p + ".attn.out_proj.weight"] = lin(w, w)
        sd[p + ".attn.out_proj.bias"] = lin(1, w)[0]
        sd[p + ".mlp.c_fc.weight"] = lin(4 * w, w)
        sd[p + ".mlp.c_fc.bias"] = lin(1, 4 * w)[0]
        sd[p + ".mlp.c_proj.weight"] = lin(w, 4 * w)
        sd[p + ".mlp.c_proj.bias"] = lin(1, w)[0]
        sd[p + ".attn.out_proj.lora_A"] = lin(4, w, 0.1)
        sd[p + ".attn.out_proj.lora_B"] = lin(w, 4, 0.1)
        sd[p + ".mlp.c_fc.lora_A.weight"] = lin(4, w, 0.1)
        sd[p + ".mlp.c_fc.lora_B.weight"] = lin(4 * w, 4, 0.1)
        sd[p + ".attn.in_proj.lora_A"] = lin(4, w, 0.1)
        sd[p + ".attn.in_proj.lora_B"] = lin(3 * w, 4, 0.1)

    for i in range(C.VISION_LAYERS):
        block(f"visual.transformer.resblocks.{i}", C.VISION_WIDTH)
    for i in range(C.TEXT_LAYERS):
        block(f"transformer.resblocks.{i}", C.TEXT_WIDTH)
    return sd


@pytest.fixture(scope="module")
def full_clip():
    """The DAC state dict converted by both packages, the port's towers on
    the CPU, 2 images and 2 token rows (EOT at 5 and at 30), and the JAX
    towers' raw embeddings of them."""
    rng = np.random.default_rng(7)
    sd = dac_state_dict(rng)
    jv, jt = J.convert_clip_state_dict(sd)
    pv, pt = C.convert_clip_state_dict({k: torch.from_numpy(np.asarray(v))
                                        for k, v in sd.items()})
    images = rng.uniform(-1, 1, (2, C.IMAGE_SIZE, C.IMAGE_SIZE, 3)).astype(np.float32)
    tokens = np.zeros((2, C.CONTEXT), np.int64)
    tokens[:, 0] = 49406
    tokens[0, 1:5] = rng.integers(1, 49000, 4)
    tokens[0, 5] = 49407
    tokens[1, 1:30] = rng.integers(1, 49000, 29)
    tokens[1, 30] = 49407
    ref_v = np.asarray(J.CLIPImageEncoder().apply({"params": jv}, jnp.asarray(images)))
    ref_t = np.asarray(J.CLIPTextEncoder().apply({"params": jt}, jnp.asarray(tokens)))
    return dict(jv=jv, jt=jt, pv=pv, pt=pt, images=images, tokens=tokens,
                ref_v=ref_v, ref_t=ref_t)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def test_converters_agree_both_ways(full_clip):
    """convert_clip_state_dict on both sides, and clip_from_jax of the JAX
    package's params, give the same port state dicts; the LoRA merge
    changed every adapted weight; logit_scale is left out."""
    fv, ft = C.clip_from_jax(full_clip["jv"], full_clip["jt"])
    for mine, theirs in ((full_clip["pv"], fv), (full_clip["pt"], ft)):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert mine[k].dtype == torch.float32 and torch.equal(mine[k], theirs[k]), k
    with torch.device("meta"):
        assert full_clip["pv"].keys() == C.CLIPImageEncoder().state_dict().keys()
        assert full_clip["pt"].keys() == C.CLIPTextEncoder().state_dict().keys()
    assert "logit_scale" not in full_clip["pt"]


@pytest.mark.parametrize("eps", ["flax", "port"])
def test_towers_match_jax(full_clip, eps):
    image_tower, text_tower = C.build_towers(full_clip["pv"], full_clip["pt"], "cpu")
    if eps == "flax":
        flax_eps(image_tower, text_tower)
    with torch.inference_mode():
        got_v = image_tower(torch.from_numpy(full_clip["images"])).numpy()
        got_t = text_tower(torch.from_numpy(full_clip["tokens"])).numpy()
    for got, ref in ((got_v, full_clip["ref_v"]), (got_t, full_clip["ref_t"])):
        assert got.shape == ref.shape == (2, C.EMBED_DIM) and np.isfinite(got).all()
        unit_err = np.abs(_unit(got) - _unit(ref)).max()
        if eps == "flax":
            assert unit_err <= UNIT_TOL
            assert np.abs(got - ref).max() <= UNIT_TOL * np.abs(ref).max()
        else:
            assert unit_err <= EPS_UNIT_TOL


def test_towers_from_jax_params(full_clip):
    """The port's towers on weights carried over from the JAX params
    (clip_from_jax) give the JAX towers' embeddings."""
    fv, ft = C.clip_from_jax(full_clip["jv"], full_clip["jt"])
    image_tower, text_tower = C.build_towers(fv, ft, "cpu")
    flax_eps(image_tower, text_tower)
    with torch.inference_mode():
        got = text_tower(torch.from_numpy(full_clip["tokens"])).numpy()
    assert np.abs(_unit(got) - _unit(full_clip["ref_t"])).max() <= UNIT_TOL


def test_encode_for_adv_matches_jax(full_clip):
    image_tower, text_tower = C.build_towers(full_clip["pv"], full_clip["pt"], "cpu")
    flax_eps(image_tower, text_tower)
    groups = [full_clip["tokens"], full_clip["tokens"][1:]]
    frames, texts = C.encode_for_adv(image_tower, text_tower, full_clip["images"], groups)
    ref_frames, ref_texts = J.encode_for_adv(full_clip["jv"], full_clip["jt"],
                                             full_clip["images"], groups)
    assert frames.dtype == np.float32 and frames.shape == (2, C.EMBED_DIM)
    np.testing.assert_allclose(np.linalg.norm(frames, axis=1), 1.0, rtol=1e-5)
    assert np.abs(frames - ref_frames).max() <= UNIT_TOL
    assert [t.shape for t in texts] == [(2, C.EMBED_DIM), (1, C.EMBED_DIM)]
    for got, ref in zip(texts, ref_texts):
        assert np.abs(got - ref).max() <= UNIT_TOL


def test_build_towers_needs_a_gpu_by_default(full_clip):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.build_towers(full_clip["pv"], full_clip["pt"])


# -------------------------------------------------------------------- ADV
@pytest.mark.parametrize("seed", range(6))
def test_kmeans_is_sklearns(seed):
    from sklearn.cluster import KMeans
    rng = np.random.default_rng(seed)
    T = int(rng.integers(6, 80))
    x = rng.standard_normal((T, 16))
    if seed % 2:                  # duplicated frames: empty clusters relocate
        x = np.repeat(x[: max(2, T // 5)], 5, 0)[:T]
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
        np.float32 if seed < 4 else np.float64)
    k = max(2, T // 4)
    with warnings.catch_warnings():  # sklearn warns when duplicates leave fewer clusters
        warnings.simplefilter("ignore")
        km = KMeans(n_clusters=k, random_state=seed, n_init="auto").fit(x)
    labels, centers = adv.kmeans(x, k, seed)
    np.testing.assert_array_equal(labels, km.labels_)
    assert centers.dtype == km.cluster_centers_.dtype
    np.testing.assert_array_equal(centers, km.cluster_centers_)


def _video_embeddings(rng, T, groups, d=32):
    """Frames in len(sentences) temporal phases, sentences near their
    phase's prototype, a few caption groups; unit rows."""
    n = sum(groups)
    protos = rng.standard_normal((n, d))
    frames = np.repeat(protos, -(-T // n), 0)[:T] + 0.3 * rng.standard_normal((T, d))
    text = protos + 0.2 * rng.standard_normal((n, d))
    frames, text = _unit(frames).astype(np.float32), _unit(text).astype(np.float32)
    out, s = [], 0
    for g in groups:
        out.append(text[s:s + g])
        s += g
    return out, frames


@pytest.mark.parametrize("T,groups", [(4, (2,)), (5, (1, 2)), (12, (3,)), (32, (2, 1, 3)),
                                      (40, (1, 1)), (9, (3, 0, 2))])
def test_align_video_equals_jax(T, groups):
    rng = np.random.default_rng(T * 10 + len(groups))
    text, frames = _video_embeddings(rng, T, groups)
    got = adv.align_video(text, frames, beta=4)
    assert same(got, jadv.align_video(text, frames, beta=4))
    assert len(got) == sum(groups)
    assert same(adv.align_sentences_to_frames(text[0], frames),
                jadv.align_sentences_to_frames(text[0], frames))
    for lst in ([5, 1, 2, 3, 9], [], [4, 7, 8, 9, 1, 2], [3]):
        assert adv.find_consecutive_numbers(lst) == jadv.find_consecutive_numbers(lst)


def _triplet_groups(rng, tax, n_sentences, n_groups=2):
    objs = list(tax.object_classes_pipeline[1:]) + ["glass"]
    preds = list(tax.relationship_classes_gt) + ["unsure"]
    subs = ["person", "person", "person", "dog"]
    per = [[(str(rng.choice(subs)), str(rng.choice(preds)), str(rng.choice(objs)))
            for _ in range(int(rng.integers(0, 4)))] for _ in range(n_sentences)]
    cut = n_sentences // n_groups
    return [per[:cut], per[cut:]]


@pytest.mark.parametrize("seed", range(4))
def test_triplet_bookkeeping_equals_jax(seed):
    """filter_triplets, broadcast_triplets and build_final_video (with
    add_info_vanilla) on seeded triplets and alignments: equal outputs,
    the error cases included."""
    rng = np.random.default_rng(seed)
    tax, jtax = schema.load_taxonomy(), jschema.load_taxonomy()
    groups = _triplet_groups(rng, tax, 6)
    T = 10
    mapped = [sorted(set(rng.integers(0, T, int(rng.integers(0, 4))).tolist()))
              for _ in range(6)]
    tri = adv.filter_triplets(groups)
    assert same(tri, jadv.filter_triplets(groups))
    per_frame = adv.broadcast_triplets(tri, mapped, T)
    assert same(per_frame, jadv.broadcast_triplets(tri, mapped, T))
    assert adv.broadcast_triplets(tri, mapped[:-1], T) is None
    first = next(i for i, t in enumerate(tri) if t)      # a sentence with triplets
    out_of_range = mapped[:first] + [[T]] + mapped[first + 1:]
    assert adv.broadcast_triplets(tri, out_of_range, T) is None
    assert jadv.broadcast_triplets(tri, out_of_range, T) is None
    final = adv.build_final_video(per_frame, tax)
    assert same(final, jadv.build_final_video(per_frame, jtax))
    assert adv.build_final_video([[] for _ in range(T)], tax) is None


# -------------------------------------------------------------- negatives
@pytest.mark.parametrize("seed", range(4))
def test_negatives_equal_jax(seed):
    rng = np.random.default_rng(seed)
    tax, jtax = schema.load_taxonomy(), jschema.load_taxonomy()
    T = 12
    groups = _triplet_groups(rng, tax, 4)
    tri = adv.filter_triplets(groups)
    mapped = [sorted(set(rng.integers(0, T, 2).tolist())) for _ in range(4)]
    per_frame = adv.broadcast_triplets(tri, mapped, T)
    final_port = adv.build_final_video(per_frame, tax) or [[] for _ in range(T)]
    final_jax = jadv.build_final_video(per_frame, jtax) or [[] for _ in range(T)]
    trend = np.cumsum(rng.uniform(-0.3, 0.1, T))  # a falling person-object gIoU
    gaps = set(rng.integers(0, T, 3).tolist())    # frames without a detection

    def giou_fn(f, obj):
        return None if f in gaps else float(trend[f])

    negatives.assign_negative_classes_video(final_port, per_frame, mapped, giou_fn, tax)
    jneg.assign_negative_classes_video(final_jax, per_frame, mapped, giou_fn, jtax)
    assert same(final_port, final_jax)
    assert same([list(x) for x in negatives.unmatched_intervals(T, mapped)],
                [list(x) for x in jneg.unmatched_intervals(T, mapped)])
    b = np.sort(rng.uniform(0, 100, (2, 4)), axis=None).reshape(2, 4)[:, [0, 2, 1, 3]]
    assert negatives.pair_giou(b[0], b[1]) == jneg.pair_giou(b[0], b[1])


def test_frame_giou_equals_jax():
    rng = np.random.default_rng(3)
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
    person = ag_to_oi[1][0]
    mapped = [k for k, v in oi_to_ag.items() if v and v[0] >= 2][:6]
    classes = np.array([person] + mapped + [person])
    rects = np.sort(rng.uniform(0, 300, (len(classes), 4)), axis=1)[:, [0, 1, 2, 3]]
    tax = schema.load_taxonomy()
    for obj in ("door", "cup", "person", "table", "sofa"):
        assert negatives.frame_person_object_giou(classes, rects, obj, tax) == \
            jneg.frame_person_object_giou(classes, rects, obj, jschema.load_taxonomy())


# ------------------------------------------------------ TCS / triplet parsers
TCS_RESPONSES = [
    "Output:  A person opens a door. >> The person picks up a book. >> 'The person reads.'",
    "Output:  Person sits. >> \"Person eats a sandwich.\"",
    "Some preamble\nOutput:  A person walks to a pantry.",
]
TRIPLET_RESPONSE = (
    "Input: A person opens a door. Output: "
    "Step 1: Triplets extracted from the sentence are <person, opens, door>. "
    "Step 2: Triplets aligned with the predefined entity/predicate lexicons "
    "are <1.person, 22.touching, 13.door> and <1.person, 0.None, 13.door> "
    "and <1.person, 15.holding, 99.spaceship>.\n"
    "Input: The person reads a book. Output: Step 1: <person, reads, book>. "
    "Step 2: <1.person, 1.looking at, 5.book>, <1.person, 15.holding, 5.book>.\n"
    "Input: Something else entirely. Output: Step 1: none. Step 2: <1.person, 3.unsure, 0.None>."
)


@pytest.mark.parametrize("response", TCS_RESPONSES)
def test_tcs_parser_equals_jax(response):
    assert tcs.parse_tcs_response(response) == jtcs.parse_tcs_response(response)


def test_run_tcs_equals_jax():
    captions = {"1ECM2.mp4": "first;second", "v2.mp4": "solo", "ESAIY.mp4": "x;y"}
    calls = iter(range(100))

    def llm(prompt):
        return TCS_RESPONSES[next(calls) % len(TCS_RESPONSES)]

    got = tcs.run_tcs(captions, list(captions), llm)
    calls = iter(range(100))
    assert got == jtcs.run_tcs(captions, list(captions), llm)
    assert tcs.MANUAL_FIXES == jtcs.MANUAL_FIXES


def test_triplet_parser_and_run_equal_jax():
    tax = schema.load_taxonomy()
    lex = (list(tax.object_classes_pipeline), list(tax.relationship_classes_gt))
    assert triplets.parse_triplet_response(TRIPLET_RESPONSE, *lex) == \
        jtri.parse_triplet_response(TRIPLET_RESPONSE, *lex)
    with pytest.raises(ValueError):
        triplets.parse_triplet_response("Input: no steps here", *lex)
    split = {"v.mp4": [["A person opens a door", "The person reads a book"],
                       ["Something else entirely"]],
             "w.mp4": [["Nothing"]]}
    frame_lists = {"v.mp4": ["000001.png", "000002.png"], "w.mp4": []}

    def llm(prompt):
        return "Input: garbage" if "Input: Nothing." in prompt else TRIPLET_RESPONSE

    got = triplets.run_triplet_extraction(split, frame_lists, llm)
    assert got == jtri.run_triplet_extraction(split, frame_lists, llm)
    assert set(got) == {"v.mp4"}
