"""Checkpoint save and restore with full train-state resume (port of
nl_vsgg_tpu/utils/checkpoint.py, with `torch.save` in place of Orbax).

The same API and directory layout as the JAX package:

    <directory>/<step>/state.pt    the TrainState: the model's state_dict
                                   (parameters and BatchNorm buffers), the
                                   ClippedAdamW state (AdamW's moments and
                                   step counts, the lr), `step` and `skipped`
    <directory>/<step>.meta.json   `extra`: host state the TrainState does
                                   not hold (the plateau scheduler's)
    <directory>/configs.json       the run's config snapshot

Each file is written under a temporary name and moved into place with
`os.replace`; a step directory appears whole, by one rename of a complete
temporary directory. A run killed mid-save leaves the previous checkpoint
readable, and `latest_step` never sees a partial one. Saves keep the newest
`keep` steps.

The files hold the one-rank layout at every mesh shape. A model sharded
over a model axis (parallel/tensor.py) is saved gathered: `state_payload`
gathers its sharded parameters and their AdamW moments over the model
group (a collective: every rank of the group calls it) and the primary
writes the payload; `restore_checkpoint` slices them back to the rank's
rows. So a checkpoint of a 1x2 run loads in a 1x1 model and the other way
round.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from ..parallel.tensor import (full_state_dict, gather_shard, load_full_state_dict,
                               shard_specs, take_shard)

STATE_FILE = "state.pt"


def _write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _moments(state) -> dict[int, tuple]:
    """{optimizer index of a sharded parameter: (TP, blocks)}."""
    specs = shard_specs(state.model)
    index = {id(p): i for i, p in enumerate(state.optimizer.params)}
    return {index[id(p)]: specs[n] for n, p in state.model.named_parameters()
            if n in specs and id(p) in index}


def _map_moments(sd: dict, moments: dict, each) -> dict:
    """AdamW's state_dict `sd` with `each(tensor, spec)` applied to the
    moments of the sharded parameters."""
    sd["state"] = {i: {k: each(v, *moments[i]) if i in moments and k != "step" else v
                       for k, v in s.items()} for i, s in sd["state"].items()}
    return sd


def state_payload(state) -> dict:
    """What a checkpoint holds, in the one-rank layout. Under tensor
    parallel this gathers over the model group: every rank of it calls."""
    return {"model": full_state_dict(state.model),
            "optimizer": _map_moments(state.optimizer.adamw.state_dict(), _moments(state),
                                      gather_shard),
            "step": int(state.step), "skipped": int(state.skipped)}


def save_checkpoint(directory: str, step: int, state, config_json: str | None = None,
                    keep: int = 3, extra: dict | None = None,
                    payload: dict | None = None) -> str:
    """Write the TrainState under directory/<step>; returns that path.

    `extra` (JSON-serializable) persists host-side training state the
    TrainState does not hold, e.g. the plateau scheduler's lr / best /
    num_bad, without which a resume would put cfg.lr back at its first
    epoch end. `payload`: the state's `state_payload`, already gathered
    (under tensor parallel the ranks gather it together, and the primary
    alone writes it)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload if payload is not None else state_payload(state),
               os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):  # a re-save of this step (the JAX side's force=True)
        shutil.rmtree(path)
    os.replace(tmp, path)
    if config_json is not None:
        _write_text(os.path.join(directory, "configs.json"), config_json)
    if extra is not None:
        _write_text(os.path.join(directory, f"{step}.meta.json"), json.dumps(extra))
    steps = sorted(int(d) for d in os.listdir(directory) if d.isdigit())
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
        meta = os.path.join(directory, f"{old}.meta.json")
        if os.path.isfile(meta):
            os.remove(meta)
    return path


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None


def load_meta(directory: str, step: int | None = None) -> dict | None:
    """The `extra` dict saved beside checkpoint `step` (the latest when
    None); None when there is none."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        return None
    p = os.path.join(os.path.abspath(directory), f"{step}.meta.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def load_state(directory: str, step: int | None = None) -> dict:
    """The saved payload of checkpoint `step` (the latest when None):
    {"model", "optimizer", "step", "skipped"}."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(model: torch.nn.Module, sd: dict) -> list[str]:
    """Load `sd` into `model` over the model's own keys, strictly; returns
    the keys under no module of the model, which are left out (a predcls
    model has no object classifier; the reference loads with
    strict=False). A missing key, a key of one of the model's modules that
    the model lacks, or a shape that differs raises, naming them."""
    own = model.state_dict()
    roots = {k.split(".")[0] for k in own}
    missing = sorted(set(own) - set(sd))
    extra = sorted(k for k in sd if k not in own and k.split(".")[0] in roots)
    shapes = sorted(f"{k}: checkpoint {tuple(sd[k].shape)}, model {tuple(v.shape)}"
                    for k, v in own.items() if k in sd and tuple(sd[k].shape) != tuple(v.shape))
    if missing or extra or shapes:
        raise ValueError(f"the checkpoint does not match the model: missing={missing} "
                         f"extra={extra} mis-shaped={shapes}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return sorted(k for k in sd if k.split(".")[0] not in roots)


def restore_checkpoint(directory: str, state, step: int | None = None):
    """Load checkpoint `step` (the latest when None) into `state`, a
    TrainState over a model of the same architecture, in place; returns the
    state. The payload is read on the host and `load_state_dict` copies each
    tensor onto the state's device (AdamW keeps its step counts on the host,
    where it made them). The model's keys and shapes must match the saved
    ones exactly; a model sharded over a model axis takes its rows of the
    one-rank layout."""
    payload = load_state(directory, step)
    load_full_state_dict(state.model, payload["model"])
    state.optimizer.adamw.load_state_dict(_map_moments(payload["optimizer"], _moments(state),
                                                       take_shard))
    state.step = int(payload["step"])
    state.skipped = int(payload["skipped"])
    return state
