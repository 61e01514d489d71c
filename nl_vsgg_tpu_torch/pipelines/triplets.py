"""LLM4SGG-style triplet extraction (NL-VSGG/extract_triplet.py); the port's
own copy of nl_vsgg_tpu/pipelines/triplets.py over the port's taxonomy.

Two-step few-shot prompt: extract <subject, predicate, object> triplets, then
align them to the 36-entity / 26-predicate lexicons. Parsing strips the
"N." numbering, maps 'None' predicates to 'unsure', keeps only triplets whose
three parts are in the lexicons (:120-131), and drops videos whose responses
are malformed or yield no triplets (:135-155). Produces the
triplets_LLM4SGG.pkl schema (frame_list + split_sentence + per-sentence
triplets).
"""

from __future__ import annotations

import pickle
import re
from typing import Callable, Mapping, Sequence

from ..data import schema
from .prompts import TRIPLET_PROMPT_HEADER

LLMFn = Callable[[str], str]
_NUM = re.compile(r"\b\d+.\s*")


def build_prompt(sentences: Sequence[str]) -> str:
    prompt = TRIPLET_PROMPT_HEADER.format(n=len(sentences))
    for c in sentences:
        prompt += f"Input: {c}. Output: "
    return prompt


def parse_triplet_response(response: str, obj_lexicon: Sequence[str],
                           pred_lexicon: Sequence[str]):
    """-> list of (input_sentence, [(sub, pred, obj), ...]) per Input block;
    raises ValueError on malformed blocks (missing Step 2)."""
    out = []
    for block in response.split("Input")[1:]:
        steps = block.split("Step")
        sentence = steps[0][1:].split("Output")[0].strip("\n").strip() \
            .strip("'").strip('"').strip(".")
        if len(steps) < 3:
            raise ValueError("missing Step 2 in response block")
        triplets = []
        for piece in steps[2].split("<")[1:]:
            parts = piece.split(",")
            if len(parts) < 3:
                continue
            sub = _NUM.sub("", parts[0].strip())
            pred = _NUM.sub("", parts[1].strip())
            obj = _NUM.sub("", parts[2].strip().strip("\n\n").split(">")[0].strip())
            if pred == "None":
                pred = "unsure"
            if sub in obj_lexicon and obj in obj_lexicon and pred in pred_lexicon:
                triplets.append((sub, pred, obj))
        out.append((sentence, triplets))
    return out


def run_triplet_extraction(split_sentences: Mapping[str, list[list[str]]],
                           frame_lists: Mapping[str, list[str]], llm: LLMFn,
                           taxonomy=None, max_retries: int = 5,
                           logger=None) -> dict:
    """split_action_dict + frame lists -> triplets_LLM4SGG.pkl payload."""
    tax = taxonomy or schema.load_taxonomy()
    obj_lexicon = list(tax.object_classes_pipeline)
    pred_lexicon = list(tax.relationship_classes_gt)

    out: dict = {}
    for vid, caption_groups in split_sentences.items():
        groups = [[s.strip().strip('"').strip("'").strip(".") for s in grp]
                  for grp in caption_groups]
        record = {
            "frame_list": frame_lists.get(vid, []),
            "split_sentence": groups,
            "triplets": [[[] for _ in grp] for grp in groups],
        }
        ok = True
        any_triplet = False
        for grp_i, grp in enumerate(groups):
            prompt = build_prompt(grp)
            response = None
            for attempt in range(max_retries):
                try:
                    response = llm(prompt)
                    break
                except Exception as e:
                    if logger:
                        logger.warning(f"triplet retry {attempt} {vid}: {e!r}")
            if response is None:
                ok = False
                break
            try:
                parsed = parse_triplet_response(response, obj_lexicon, pred_lexicon)
            except ValueError:
                ok = False  # malformed -> video dropped (:135-137)
                break
            for sentence, triplets in parsed:
                # locate the sentence in the split groups (:106-113)
                idx = jdx = -1
                for i, g in enumerate(groups):
                    for j, s in enumerate(g):
                        if sentence.strip(".").lower() == s.lower():
                            idx, jdx = i, j
                if idx == -1 and logger:
                    # ref :111-112 prints the video id; its append then uses
                    # the -1 indices, landing the triplets in the LAST
                    # group's LAST sentence slot (negative-index quirk :129)
                    logger.warning(f"{vid}: LLM echoed an unmatched Input "
                                   f"sentence {sentence!r} — triplets land "
                                   f"in the last sentence slot (ref quirk)")
                if triplets:
                    if idx == -1 and not record["triplets"][-1]:
                        # the quirk's landing slot [-1][-1] doesn't exist
                        # when the last sentence group parsed empty — the
                        # reference would IndexError here; drop instead
                        continue
                    record["triplets"][idx][jdx].extend(triplets)
                    any_triplet = True
        if ok and any_triplet:
            out[vid] = record
    return out


def save_triplets(payload: dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(payload, f)
