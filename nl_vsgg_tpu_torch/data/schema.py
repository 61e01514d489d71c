"""Action Genome label schema: class counts, the taxonomy and the
OpenImages -> AG class maps.

Own copy of nl_vsgg_tpu/data/schema.py (the port imports nothing of the
JAX package). It reads the same `assets/*.txt` and `assets/*.npy` files and
applies the same name canonicalization (dataloader/wk_action_genome.py:25-87
of the reference). The 26 predicates split positionally: attention=[0:3],
spatial=[3:9], contacting=[9:26].
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets")

NUM_OBJ_CLASSES = 37  # 36 + __background__
NUM_ATTENTION = 3
NUM_SPATIAL = 6
NUM_CONTACTING = 17
NUM_PREDICATES = NUM_ATTENTION + NUM_SPATIAL + NUM_CONTACTING  # 26

_OBJ_DISPLAY_FIX = {9: "closet/cabinet", 11: "cup/glass/bottle", 23: "paper/notebook",
                    24: "phone/camera", 31: "sofa/couch"}
_OBJ_GT_FIX = {9: "cabinet", 11: "glass", 23: "paper", 24: "phone", 31: "sofa"}
_OBJ_PIPELINE_FIX = {9: "cabinet", 11: "cup", 23: "paper", 24: "phone", 31: "sofa"}

_REL_DISPLAY_FIX = {0: "looking_at", 1: "not_looking_at", 5: "in_front_of",
                    7: "on_the_side_of", 10: "covered_by", 11: "drinking_from",
                    13: "have_it_on_the_back", 15: "leaning_on", 16: "lying_on",
                    17: "not_contacting", 18: "other_relationship", 19: "sitting_on",
                    20: "standing_on", 25: "writing_on"}
_REL_GT_FIX = {k: v.replace("_", " ") for k, v in _REL_DISPLAY_FIX.items()}


def _read_lines(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip("\n") for line in f if line.strip("\n")]


@dataclass(frozen=True)
class Taxonomy:
    """All class-name variants plus predicate group ranges."""

    object_classes: tuple[str, ...]           # display names, 0 = __background__
    object_classes_gt: tuple[str, ...]        # LLM-pipeline lexicon spellings
    object_classes_pipeline: tuple[str, ...]  # ADV/LLM pipeline spellings
    relationship_classes: tuple[str, ...]     # display names
    relationship_classes_gt: tuple[str, ...]  # pipeline/chart spellings

    @property
    def attention_relationships(self) -> tuple[str, ...]:
        return self.relationship_classes[0:NUM_ATTENTION]

    @property
    def spatial_relationships(self) -> tuple[str, ...]:
        return self.relationship_classes[NUM_ATTENTION:NUM_ATTENTION + NUM_SPATIAL]

    @property
    def contacting_relationships(self) -> tuple[str, ...]:
        return self.relationship_classes[NUM_ATTENTION + NUM_SPATIAL:]

    @property
    def attention_relationships_gt(self) -> tuple[str, ...]:
        return self.relationship_classes_gt[0:NUM_ATTENTION]

    @property
    def spatial_relationships_gt(self) -> tuple[str, ...]:
        return self.relationship_classes_gt[NUM_ATTENTION:NUM_ATTENTION + NUM_SPATIAL]

    @property
    def contacting_relationships_gt(self) -> tuple[str, ...]:
        return self.relationship_classes_gt[NUM_ATTENTION + NUM_SPATIAL:]


@functools.lru_cache(maxsize=4)
def load_taxonomy(assets_dir: str | None = None) -> Taxonomy:
    d = assets_dir or ASSETS_DIR
    raw_obj = ["__background__"] + _read_lines(os.path.join(d, "object_classes.txt"))
    raw_rel = _read_lines(os.path.join(d, "relationship_classes.txt"))
    if len(raw_obj) != NUM_OBJ_CLASSES or len(raw_rel) != NUM_PREDICATES:
        raise ValueError(f"taxonomy under {d}: {len(raw_obj)} object and "
                         f"{len(raw_rel)} relationship classes, expected "
                         f"{NUM_OBJ_CLASSES} and {NUM_PREDICATES}")

    def fixed(raw, fixes):
        out = list(raw)
        for i, v in fixes.items():
            out[i] = v
        return tuple(out)

    return Taxonomy(fixed(raw_obj, _OBJ_DISPLAY_FIX), fixed(raw_obj, _OBJ_GT_FIX),
                    fixed(raw_obj, _OBJ_PIPELINE_FIX),
                    fixed(raw_rel, _REL_DISPLAY_FIX), fixed(raw_rel, _REL_GT_FIX))


@functools.lru_cache(maxsize=4)
def load_oi_ag_maps(assets_dir: str | None = None
                    ) -> tuple[dict[int, list[int]], dict[int, list[int]]]:
    """(oi_to_ag, ag_to_oi) class-id maps (lib/assign_pseudo_label.py:894-896)."""
    d = assets_dir or ASSETS_DIR
    oi_to_ag = np.load(os.path.join(d, "oi_to_ag_word_map_synset.npy"), allow_pickle=True).tolist()
    ag_to_oi = np.load(os.path.join(d, "ag_to_oi_word_map_synset.npy"), allow_pickle=True).tolist()
    return oi_to_ag, ag_to_oi


@functools.lru_cache(maxsize=4)
def oi_to_ag_matrix(assets_dir: str | None = None) -> np.ndarray:
    """Dense (1595, 37) 0/1 form of the OI -> AG map. Row 1594 is aliased to
    row 1593 (the reference's remap, lib/assign_pseudo_label.py:114-115)."""
    oi_to_ag, _ = load_oi_ag_maps(assets_dir)
    m = np.zeros((1595, NUM_OBJ_CLASSES), dtype=np.float32)
    for oi_id, ag_ids in oi_to_ag.items():
        for ag in ag_ids:
            m[oi_id, ag] = 1.0
    m[1594] = m[1593]
    return m


@functools.lru_cache(maxsize=4)
def person_oi_ids(assets_dir: str | None = None) -> tuple[int, ...]:
    """OpenImages class ids that map to AG 'person' (ag_to_oi[1])."""
    _, ag_to_oi = load_oi_ag_maps(assets_dir)
    return tuple(ag_to_oi[1])
