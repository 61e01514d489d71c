"""CLIP ViT-B/32 (the DAC VLM) in PyTorch, with LoRA weight merging: the port
of nl_vsgg_tpu/pipelines/clip_jax.py.

The reference's ADV stage encodes captions and frames with DAC — open_clip
ViT-B/32 plus rank-4 LoRA adapters loaded from LLM_cp.pt
(NL-VSGG/ADV.py:30-52). This module provides:

  * `ResidualBlock`, `CLIPImageEncoder`, `CLIPTextEncoder` — the standard
    CLIP towers (pre-norm transformer, quick-gelu, causal text mask, EOT
    pooling, learned projections). Their parameter names are open_clip's
    without the `visual.` prefix, so a DAC state dict loads by key. Every
    attention runs through the port's `models.layers.MaskedMHA` with a
    (B, L, L) allow mask (all true for images, lower-triangular for text):
    with `fused=True` (the default) the attention core is the CUDA kernel
    of csrc/masked_attention.cu on a GPU (12 vision heads take its
    per-element route, 8 text heads of 64 in float32 its tiled route) and
    its plain version on the CPU; `fused=False` runs the plain version on
    any device (a comparison path). The JAX package runs XLA attention
    here (`fused=False`, clip_jax.py:57-60).
  * `convert_clip_state_dict` — an openai-CLIP / open_clip state dict ->
    the two towers' state dicts, *merging* LoRA adapters
    (W <- W + scale * B @ A) at conversion time, so inference runs dense
    with no adapter overhead; `clip_from_jax` — the JAX package's flax
    params -> the same state dicts.
  * `build_towers` — both towers on a device, frozen, in eval mode;
    `encode_for_adv` — unit-normalized frame and sentence embeddings as
    numpy, in the form pipelines/adv.py consumes.
  * `validate_checkpoint` — a functional-torch evaluation of a raw
    LLM_cp.pt (LoRA applied at run time, as DAC does) against the towers
    (LoRA merged), per tower (tools/validate_ckpt.py clip).

LayerNorm eps is open_clip's 1e-5 (`LN_EPS`), the DAC reference's; the JAX
towers use flax's 1e-6, a relative difference of about 5e-6 on
unit-variance rows. Images are NHWC (B, 224, 224, 3) float32 as in the JAX
package; the 32x32 stride-32 patch embedding is one product over the
unfolded patches. Everything runs in float32; `F.linear` on a GPU follows
`torch.backends.cuda.matmul.allow_tf32`, which this module never sets.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.layers import MaskedMHA

EMBED_DIM = 512
VISION_WIDTH = 768
VISION_LAYERS = 12
VISION_HEADS = 12
PATCH = 32
IMAGE_SIZE = 224
TEXT_WIDTH = 512
TEXT_LAYERS = 12
TEXT_HEADS = 8
CONTEXT = 77
VOCAB = 49408
LN_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quick_gelu(x)


class ResidualBlock(nn.Module):
    """open_clip's ResidualAttentionBlock: x + attn(ln_1(x)), then
    x + mlp(ln_2(x)), the attention over a (B, L, L) allow mask."""

    def __init__(self, width: int, heads: int, fused: bool = True):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MaskedMHA(width, heads, fused=fused)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Sequential(OrderedDict(c_fc=nn.Linear(width, 4 * width),
                                             gelu=QuickGELU(),
                                             c_proj=nn.Linear(4 * width, width)))

    def forward(self, x: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, allow)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, fused: bool = True):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads, fused)
                                       for _ in range(layers))

    def forward(self, x: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, allow)
        return x


def allow_mask(batch: int, length: int, causal: bool, device) -> torch.Tensor:
    """The (batch, length, length) bool allow mask of one tower forward, in
    memory once and shared by its layers (the kernels read it as it is)."""
    m = torch.ones(length, length, dtype=torch.bool, device=device)
    if causal:
        m = m.tril()
    return m.expand(batch, length, length).contiguous()


class CLIPImageEncoder(nn.Module):
    """ViT-B/32 visual tower: NHWC images (B, 224, 224, 3) -> (B, embed_dim)."""

    def __init__(self, width: int = VISION_WIDTH, layers: int = VISION_LAYERS,
                 heads: int = VISION_HEADS, patch: int = PATCH, image_size: int = IMAGE_SIZE,
                 embed_dim: int = EMBED_DIM, fused: bool = True):
        super().__init__()
        self.patch = patch
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros((image_size // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        self.transformer = Transformer(width, layers, heads, fused)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, Hi, Wi, C = images.shape
        p = self.patch
        # (B, Hi/p, p, Wi/p, p, C) -> (B, patches, C * p * p) in conv1's (c, kh, kw) order
        patches = images.reshape(B, Hi // p, p, Wi // p, p, C).permute(0, 1, 3, 5, 2, 4)
        x = F.linear(patches.reshape(B, (Hi // p) * (Wi // p), C * p * p),
                     self.conv1.weight.flatten(1))
        cls = self.class_embedding.expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        x = self.transformer(x, allow_mask(B, x.shape[1], False, x.device))
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPTextEncoder(nn.Module):
    """Text tower: token ids (B, L <= 77) -> (B, embed_dim), causal
    attention, pooled at the EOT token (the highest id of each row)."""

    def __init__(self, width: int = TEXT_WIDTH, layers: int = TEXT_LAYERS,
                 heads: int = TEXT_HEADS, context: int = CONTEXT, vocab: int = VOCAB,
                 embed_dim: int = EMBED_DIM, fused: bool = True):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context, width))
        self.transformer = Transformer(width, layers, heads, fused)
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, L = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:L]
        x = self.transformer(x, allow_mask(B, L, True, x.device))
        x = self.ln_final(x)
        pooled = x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


# ---------------- weight conversion (with LoRA merging) ----------------

def _lora_key_pairs(key: str) -> list[tuple[str, str]]:
    """Candidate (lora_A, lora_B) key names for a weight tensor `key`.

    Covers both '<stem>.lora_A' and '<stem>.lora_A.weight' spellings, and the
    attention input projection whose tensor is named 'in_proj_weight' (no
    '.weight' suffix) but whose adapters live under 'in_proj.lora_A'.
    """
    stems = []
    if key.endswith(".weight"):
        stems.append(key[: -len(".weight")])
    if key.endswith("in_proj_weight"):
        stems.append(key[: -len("_weight")])  # ...attn.in_proj
    out = []
    for s in stems:
        out.append((s + ".lora_A", s + ".lora_B"))
        out.append((s + ".lora_A.weight", s + ".lora_B.weight"))
    return out


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _merge_lora(sd: Mapping[str, Any], key: str, scale: float = 1.0) -> np.ndarray:
    """W + scale * (lora_B @ lora_A) when adapters exist for `key`."""
    w = _np32(sd[key])
    for ak, bk in _lora_key_pairs(key):
        if ak in sd and bk in sd:
            return w + scale * (_np32(sd[bk]) @ _np32(sd[ak]))
    return w


def convert_clip_state_dict(sd: Mapping[str, Any], lora_scale: float = 1.0):
    """openai-CLIP / open_clip state dict (numpy or torch values, optionally
    with LoRA adapters and a `module.` prefix) -> (visual, text) state dicts
    of `CLIPImageEncoder` / `CLIPTextEncoder` at ViT-B/32's widths, float32
    on the host, each adapted weight merged. Keys the towers do not have
    (logit_scale, the adapters) are left out; a missing one raises."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    with torch.device("meta"):
        towers = (("visual.", CLIPImageEncoder()), ("", CLIPTextEncoder()))
    out = []
    for prefix, tower in towers:
        keys = tower.state_dict().keys()
        missing = [prefix + k for k in keys if prefix + k not in sd]
        if missing:
            raise KeyError(f"the CLIP state dict has no {missing[0]} "
                           f"({len(missing)} tower keys missing)")
        out.append({k: torch.from_numpy(_merge_lora(sd, prefix + k, lora_scale)) for k in keys})
    return out[0], out[1]


def _ln_from_jax(p) -> tuple[np.ndarray, np.ndarray]:
    return _np32(p["scale"]), _np32(p["bias"])


def _block_from_jax(p: Mapping, out: dict, prefix: str) -> None:
    a = p["attn"]
    out[prefix + "attn.in_proj_weight"] = np.concatenate(
        [_np32(a[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
    out[prefix + "attn.in_proj_bias"] = np.concatenate(
        [_np32(a[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
    out[prefix + "attn.out_proj.weight"] = _np32(a["out_proj"]["kernel"]).T
    out[prefix + "attn.out_proj.bias"] = _np32(a["out_proj"]["bias"])
    for ln in ("ln_1", "ln_2"):
        out[prefix + ln + ".weight"], out[prefix + ln + ".bias"] = _ln_from_jax(p[ln])
    for src, dst in (("mlp_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj")):
        out[f"{prefix}{dst}.weight"] = _np32(p[src]["kernel"]).T
        out[f"{prefix}{dst}.bias"] = _np32(p[src]["bias"])


def _blocks(params: Mapping) -> list[str]:
    return sorted((k for k in params if k.startswith("block_")), key=lambda k: int(k[6:]))


def clip_from_jax(visual_params: Mapping, text_params: Mapping):
    """The JAX package's flax params (clip_jax.CLIPImageEncoder /
    CLIPTextEncoder, numpy leaves) -> (visual, text) state dicts of the
    port's towers: HWIO -> OIHW, Dense (in, out) -> (out, in), the q/k/v
    projections packed into in_proj."""
    v: dict = {"conv1.weight": _np32(visual_params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
               "class_embedding": _np32(visual_params["class_embedding"]),
               "positional_embedding": _np32(visual_params["positional_embedding"]),
               "proj": _np32(visual_params["proj"])}
    for ln in ("ln_pre", "ln_post"):
        v[ln + ".weight"], v[ln + ".bias"] = _ln_from_jax(visual_params[ln])
    for i, name in enumerate(_blocks(visual_params)):
        _block_from_jax(visual_params[name], v, f"transformer.resblocks.{i}.")
    t: dict = {"token_embedding.weight": _np32(text_params["token_embedding"]),
               "positional_embedding": _np32(text_params["positional_embedding"]),
               "text_projection": _np32(text_params["text_projection"])}
    t["ln_final.weight"], t["ln_final.bias"] = _ln_from_jax(text_params["ln_final"])
    for i, name in enumerate(_blocks(text_params)):
        _block_from_jax(text_params[name], t, f"transformer.resblocks.{i}.")
    return ({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in v.items()},
            {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in t.items()})


def build_towers(visual_sd: Mapping[str, torch.Tensor], text_sd: Mapping[str, torch.Tensor],
                 device=None, fused: bool = True):
    """(CLIPImageEncoder, CLIPTextEncoder) at ViT-B/32's widths with these
    weights on `device` (None: the GPU, which raises without one; pass
    "cpu" for the CPU), frozen, in eval mode."""
    dev = resolve_device(device)
    towers = []
    for cls, sd in ((CLIPImageEncoder, visual_sd), (CLIPTextEncoder, text_sd)):
        with torch.device("meta"):  # no host-side init of the weights
            tower = cls(fused=fused)
        tower.to_empty(device=dev).load_state_dict(dict(sd))
        towers.append(tower.requires_grad_(False).eval())
    return towers[0], towers[1]


# ---------------- checkpoint validation (tools/validate_ckpt.py) ----------

def _t_linear_lora(x, sd, key, scale):
    """torch linear applying LoRA the way the DAC runtime does:
    y = x W^T + b + scale * (x A^T) B^T  — NOT via a pre-merged weight, so a
    conversion-side merge bug cannot cancel out. Shares _lora_key_pairs with
    the converter so both sides resolve adapters identically; the coverage
    check in validate_checkpoint catches adapter keys NEITHER side consumed."""
    w = sd[key]
    # 'in_proj_weight' has no '.weight' suffix: its bias is added by the caller
    b = sd.get(key[:-7] + ".bias") if key.endswith(".weight") else None
    y = F.linear(x, w, b)
    for ak, bk in _lora_key_pairs(key):
        if ak in sd and bk in sd:
            y = y + scale * F.linear(F.linear(x, sd[ak]), sd[bk])
            break
    return y


def _t_block(x, sd, p, heads, causal, scale):
    def ln(v, key):
        return F.layer_norm(v, (v.shape[-1],), sd[key + ".weight"], sd[key + ".bias"])

    B, L, D = x.shape
    h = ln(x, p + ".ln_1")
    qkv = _t_linear_lora(h, sd, p + ".attn.in_proj_weight", scale)
    # in_proj bias lives under a different key than .weight->.bias mapping
    if p + ".attn.in_proj_bias" in sd:
        qkv = qkv + sd[p + ".attn.in_proj_bias"]
    q, k, v = qkv.chunk(3, -1)
    hd = D // heads
    q = q.view(B, L, heads, hd).transpose(1, 2)
    k = k.view(B, L, heads, hd).transpose(1, 2)
    v = v.view(B, L, heads, hd).transpose(1, 2)
    att = (q @ k.transpose(-2, -1)) / hd ** 0.5
    if causal:
        keep = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
        att = att.masked_fill(~keep, float("-inf"))
    o = (att.softmax(-1) @ v).transpose(1, 2).reshape(B, L, D)
    o = _t_linear_lora(o, sd, p + ".attn.out_proj.weight", scale)
    x = x + o
    h = ln(x, p + ".ln_2")
    h = _t_linear_lora(h, sd, p + ".mlp.c_fc.weight", scale)
    h = h * torch.sigmoid(1.702 * h)
    h = _t_linear_lora(h, sd, p + ".mlp.c_proj.weight", scale)
    return x + h


def validate_checkpoint(path: str, atol: float = 5e-3, lora_scale: float = 1.0,
                        log: Callable[[str], Any] = print, device=None) -> dict[str, float]:
    """Per-tower embedding diff on fixed inputs: a functional-torch
    evaluation of the raw LLM_cp.pt tensors (LoRA applied at run time, as
    DAC does) vs the port's towers (LoRA merged at conversion), both on
    `device` (None: the GPU). A tower passes when max|diff| <= atol *
    max(1, max|ref|); a LoRA adapter key that resolves to no weight fails
    the check. Returns {tower: max_abs_diff, '_ok': 0/1} (and
    'unconsumed_lora_keys' when there are orphans)."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {k.removeprefix("module."): torch.as_tensor(np.asarray(v)).float()
          for k, v in sd.items()}
    visual_sd, text_sd = convert_clip_state_dict(sd, lora_scale)

    # adapter-coverage check: an adapter spelling neither side resolves would
    # make both sides agree while diverging from the DAC runtime
    consumable: set = set()
    for k in sd:
        for ak, bk in _lora_key_pairs(k):
            consumable.add(ak)
            consumable.add(bk)
    orphans = sorted(k for k in sd if ".lora_" in k and k not in consumable)

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    tokens = np.zeros((2, CONTEXT), np.int64)
    tokens[:, 0] = 49406
    tokens[0, 1:5] = rng.integers(1, 49000, 4)
    tokens[0, 5] = 49407
    tokens[1, 1:9] = rng.integers(1, 49000, 8)
    tokens[1, 9] = 49407

    sd = {k: v.to(dev) for k, v in sd.items()}
    img_t = torch.as_tensor(images, device=dev)
    tok_t = torch.as_tensor(tokens, device=dev)
    with torch.inference_mode():
        # --- visual tower
        x = F.conv2d(img_t.permute(0, 3, 1, 2), sd["visual.conv1.weight"], stride=PATCH)
        x = x.flatten(2).transpose(1, 2)
        cls = sd["visual.class_embedding"].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + sd["visual.positional_embedding"]
        x = F.layer_norm(x, (x.shape[-1],), sd["visual.ln_pre.weight"],
                         sd["visual.ln_pre.bias"])
        for i in range(VISION_LAYERS):
            x = _t_block(x, sd, f"visual.transformer.resblocks.{i}",
                         VISION_HEADS, False, lora_scale)
        x = F.layer_norm(x[:, 0], (x.shape[-1],), sd["visual.ln_post.weight"],
                         sd["visual.ln_post.bias"])
        ref_v = (x @ sd["visual.proj"]).cpu().numpy()
        # --- text tower
        t = sd["token_embedding.weight"][tok_t] + sd["positional_embedding"]
        for i in range(TEXT_LAYERS):
            t = _t_block(t, sd, f"transformer.resblocks.{i}",
                         TEXT_HEADS, True, lora_scale)
        t = F.layer_norm(t, (t.shape[-1],), sd["ln_final.weight"], sd["ln_final.bias"])
        pooled = t[torch.arange(2, device=dev), tok_t.argmax(-1)]
        ref_t = (pooled @ sd["text_projection"]).cpu().numpy()
        del sd
        image_tower, text_tower = build_towers(visual_sd, text_sd, dev)
        got_v = image_tower(img_t).cpu().numpy()
        got_t = text_tower(tok_t).cpu().numpy()

    diffs: dict[str, float] = {}
    ok = True
    for stage, ref, got in (("visual_embed", ref_v, got_v),
                            ("text_embed", ref_t, got_t)):
        d = float(np.abs(ref - got).max())
        scale = float(np.abs(ref).max()) or 1.0
        diffs[stage] = d
        status = "ok" if d <= atol * max(1.0, scale) else "FAIL"
        ok &= status == "ok"
        log(f"  {stage:<14} max|Δ| = {d:.3e}  (|ref|max {scale:.2e})  {status}")
    if orphans:
        ok = False
        diffs["unconsumed_lora_keys"] = float(len(orphans))
        log(f"  FAIL: {len(orphans)} LoRA adapter keys resolve to no weight "
            f"(first: {orphans[0]}) — merge would silently skip them")
    diffs["_ok"] = float(ok)
    return diffs


def _unit(x: torch.Tensor) -> np.ndarray:
    return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).cpu().numpy()


@torch.inference_mode()
def encode_for_adv(image_tower: CLIPImageEncoder, text_tower: CLIPTextEncoder,
                   images: np.ndarray, token_batches: list[np.ndarray]):
    """-> (frame_embeddings (T, 512), [sentence_embeddings (S_i, 512)]) as
    float32 numpy, unit-normalized like ADV.py:104-118. The towers
    (`build_towers`) run on the device they were built on; the images
    (T, 224, 224, 3) and each caption group's tokens (S_i, 77) are copied
    there, one forward each."""
    dev = image_tower.proj.device
    frames = _unit(image_tower(torch.as_tensor(np.asarray(images, np.float32), device=dev)))
    sentences = [_unit(text_tower(torch.as_tensor(np.asarray(t, np.int64), device=dev)))
                 for t in token_batches]
    return frames, sentences
