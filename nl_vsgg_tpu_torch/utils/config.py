"""Typed configuration (port of nl_vsgg_tpu/utils/config.py).

The same keys, defaults, type coercion and validation errors as the JAX
package's `Config`, so one YAML file (`configs/nl_vsgg_config.yml`) or one
set of overrides configures either package, and `dataclasses.asdict` of the
two agree. Configs are immutable values passed down the stack.

`yaml` is imported only when a YAML file is read: `load_config(None,
overrides)` and a `.json` file (a run's `configs.json` snapshot) need
nothing beyond the standard library.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class BucketConfig:
    """Padding ladders. A video is padded to the smallest rung that fits its
    exact post-grounding counts (data/entry.pick_joint_bucket: the box and
    relation ladders pair by rung index)."""

    max_frames: tuple[int, ...] = (8, 16, 32, 64, 128)
    max_boxes: tuple[int, ...] = (64, 96, 144, 224, 376)
    max_rels: tuple[int, ...] = (40, 64, 96, 152, 272)


@dataclass(frozen=True)
class MeshConfig:
    """Device layout. `data` shards videos; `model` shards wide layers."""

    data: int = -1  # -1 = all devices
    model: int = 1


@dataclass(frozen=True)
class Config:
    # --- the reference's flags (lib/config.py:10-59); every key parses, so
    # its YAML files stay drop-in, including the keys its own train and test
    # paths never read ---
    gpu_id: int = 0
    multi_gpus: bool = False
    num_workers: int = 4
    mode: str = "sgdet"  # sgdet | sgcls | predcls
    transformer_mode: str = "wk"
    model_path: str = ""
    optimizer: str = "adamw"
    lr: float = 1e-5
    text_encoder_lr: float = 1e-5
    lr_backbone: float = 1e-5
    schedule: str = "step"
    nepoch: int = 10
    enc_layer: int = 1
    dec_layer: int = 3
    is_wks: bool = True
    bce_loss: bool = True
    feat_dim: int = 2048
    pseudo_way: int = 0
    remove_one_frame_video: bool = True
    union_box_feature: bool = True
    loss: str = "BCE"
    teacher_model_path: str = ""
    save_path: str = ""
    data_path: str = ""
    datasize: str = "large"
    ckpt: str | None = None
    ws_object_bbox_path: str | None = None
    pseudo_localized_SG_path: str = "datasets/AG/final_ag_data_w_neg.pkl"
    exp_name: str = "defaultExp"
    tensorboard_name: str = "runs/scalar_example"
    lr_drop: int = 60
    fraction_warmup_steps: float = 0.01

    # --- the system's own keys ---
    seed: int = 1000
    dtype: str = "float32"  # compute dtype: float32 | bfloat16 (params stay fp32)
    grad_clip_norm: float = 5.0
    weight_decay: float = 1e-2
    batch_videos: int = 1  # videos per train step
    frame_features_path: str = "datasets/AG/frame_features"
    frames_path: str = ""  # raw frame images ("" -> <data_path>/frames), read
    # by the live union-feature provider
    vinvl_ckpt: str = ""  # VinVL checkpoint for live union features; "" with
    # union_box_feature on -> zeros and a warning
    vinvl_dtype: str = "float32"  # the union provider's detector dtype
    auto_download: bool = False  # fetch missing AG training pickles (opt-in)
    glove_path: str = ""  # optional glove.6B.200d.txt
    buckets: BucketConfig = field(default_factory=BucketConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    use_native_io: bool = True  # C++ .npy reader for the host data path
    use_native_grounding: bool = True  # C++ grounding engine (native/
    # grounding.cpp, byte-identical to the python path); falls back to
    # python when the library or the dets_f32.npy sidecars are missing
    device_spatial_masks: bool = True  # rasterize the 27x27 pair masks on
    # the device from boxes[pair_idx] instead of building them on the host
    profile_steps: int = 0  # >0: trace this many train steps
    device_eval: bool = False  # also score R@K on the device in the epoch eval
    device_eval_promote: bool = False  # promote the device scorer after a
    # burn-in of exact host/device agreement (eval/epoch.DeviceEvalPromotion)
    device_eval_burnin: int = 16
    device_eval_recheck: int = 64
    remat: bool = False  # recompute the temporal layers in the backward
    fused_attention: bool = False  # the JAX package's Pallas switch; the
    # port always runs its attention kernels on the card
    distributed: bool = False  # multi-process training
    coordinator_address: str = ""  # host:port of process 0
    num_processes: int = -1
    process_id: int = -1
    union_feat_cache: str = ""  # directory of the on-disk union-feature cache
    union_feat_cache_dtype: str = "float16"  # its storage dtype (and that of
    # union_feat in the Entry cache): float16 or float32
    entry_cache: str = ""  # directory of the packed-Entry disk cache
    # (data/entry_cache.py)
    device_entry_store_gb: float = 0.0  # >0: the device-resident Entry
    # store (data/device_store.py) up to this many GB
    prng_impl: str = "rbg"  # the JAX package's PRNG choice; the port draws
    # its randomness from a torch.Generator

    def __post_init__(self):
        # live keys fail fast on typos ('bf16', 'fp32', ...) instead of
        # silently running the other path
        for name in ("dtype", "vinvl_dtype"):
            v = getattr(self, name)
            if v not in ("float32", "bfloat16"):
                raise ValueError(f"{name}={v!r}: expected 'float32' or 'bfloat16'")
        if self.union_feat_cache_dtype not in ("float32", "float16"):
            raise ValueError(
                f"union_feat_cache_dtype={self.union_feat_cache_dtype!r}: "
                f"expected 'float32' or 'float16'")
        if self.prng_impl not in ("rbg", "unsafe_rbg", "threefry2x32"):
            raise ValueError(f"prng_impl={self.prng_impl!r}: expected 'rbg', "
                             f"'unsafe_rbg' or 'threefry2x32'")

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _coerce(old: Any, new: Any, key: str) -> Any:
    """The reference's type coercion (lib/config.py:70-94)."""
    if old is None or new is None:
        return None if new == "None" else new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            return new.lower() == "true"
        return bool(new)
    if isinstance(old, (tuple, list)) and isinstance(new, str):
        return tuple(int(v) for v in new.split(","))
    if type(old) is type(new):
        return new
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, str):
        return str(new)
    raise ValueError(f"Type mismatch ({type(old)} vs {type(new)}) for config key: {key}")


def _coerce_nested(k: str, v: Any):
    """buckets / mesh from a mapping ({max_boxes: [32, 64], ...} or
    {data: -1, model: 2}); bucket lists sorted ascending (pick_bucket takes
    the first fit)."""
    cls = {"buckets": BucketConfig, "mesh": MeshConfig}[k]
    if isinstance(v, cls):
        return v
    if not isinstance(v, dict):
        raise ValueError(f"config key {k} expects a mapping, got {v!r}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(v) - fields
    if unknown:
        raise ValueError(f"unknown {k} keys: {sorted(unknown)}")
    return cls(**{kk: tuple(sorted(int(x) for x in vv)) if isinstance(vv, (list, tuple))
                  else int(vv) for kk, vv in v.items()})


def load_config(path: str | None = None, overrides: dict[str, Any] | None = None) -> Config:
    """A Config from an optional YAML file plus keyword overrides.

    A path ending in `.json` is read as JSON (`Config.to_json`'s snapshot).
    Unknown file keys are ignored, as the reference's merge ignores them;
    an unknown override raises KeyError."""
    cfg = Config()
    merged: dict[str, Any] = {}
    if path:
        with open(path) as f:
            if path.endswith(".json"):
                raw = json.load(f)
            else:
                import yaml
                raw = yaml.safe_load(f) or {}
        for k, v in raw.items():
            if k in ("buckets", "mesh"):
                merged[k] = _coerce_nested(k, v)
            elif hasattr(cfg, k):
                merged[k] = _coerce(getattr(cfg, k), v, k)
    if overrides:
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise KeyError(f"unknown config key: {k}")
            if k in ("buckets", "mesh"):
                merged[k] = _coerce_nested(k, v)
            else:
                merged[k] = _coerce(getattr(cfg, k), v, k)
    return cfg.replace(**merged)
