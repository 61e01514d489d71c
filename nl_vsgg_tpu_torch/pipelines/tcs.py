"""TCS — Temporality-aware Caption Segmentation (NL-VSGG/TCS.py); the port's
own copy of nl_vsgg_tpu/pipelines/tcs.py.

Splits compositional Charades captions into chronologically ordered simple
sentences via an 8-shot LLM prompt, producing split_action_dict.pkl.

Redesign vs the reference script: the LLM call sits behind an injected
`llm(prompt) -> str` callable (the reference hardcodes openai GPT-3.5 with an
infinite bare-except retry loop, :53-63 — here retries are bounded and
logged), and parsing is a pure function so it is unit-testable without
network. Output pickles keep the reference schema so downstream stages are
drop-in.
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from typing import Callable, Mapping, Sequence

from .prompts import TCS_PROMPT

LLMFn = Callable[[str], str]


def parse_tcs_response(response: str) -> list[str]:
    """LLM response -> ordered simple sentences (NL-VSGG/TCS.py:67-75)."""
    action_sequences = response.split("Output")[1][3:].strip()
    return [s.strip().strip("'").strip('"').strip(".")
            for s in action_sequences.split(">>")]


# the reference hand-fixes 4 malformed responses (:77-81)
MANUAL_FIXES = {
    ("1ECM2.mp4", 1, 0): "A person is holding a broom while walking in a closet",
    ("ESAIY.mp4", 1, 1): "A person is taking medicine",
    ("SOTQ1.mp4", 1, 1): "The other person is sitting cross-legged on a table apparently doing homework",
    ("X1624.mp4", 1, 2): "A person takes off a jacket while holding a broom",
}


def run_tcs(captions: Mapping[str, str], video_ids: Sequence[str], llm: LLMFn,
            max_retries: int = 5, apply_manual_fixes: bool = True,
            logger=None) -> dict[str, list[list[str]]]:
    """caption_dict + frame-listed video ids -> split sentences per caption.

    captions[vid] is the raw Charades description (';'-separated captions).
    """
    raw = defaultdict(list)
    for vid in video_ids:
        for input_caption in captions[vid].split(";"):
            prompt = TCS_PROMPT.format(input_caption=input_caption)
            response = None
            for attempt in range(max_retries):
                try:
                    response = llm(prompt)
                    break
                except Exception as e:  # bounded retry (ref loops forever :53-63)
                    if logger:
                        logger.warning(f"TCS retry {attempt} for {vid}: {e!r}")
            if response is None:
                raise RuntimeError(f"LLM failed for video {vid}")
            raw[vid].append(response)

    out: dict[str, list[list[str]]] = defaultdict(list)
    for vid, responses in raw.items():
        for r in responses:
            out[vid].append(parse_tcs_response(r))
    if apply_manual_fixes:
        for (vid, i, j), text in MANUAL_FIXES.items():
            if vid not in out:  # defaultdict access would INSERT an empty
                continue        # video entry into the returned artifact
            try:
                out[vid][i][j] = text
            except IndexError:
                pass
    return dict(out)


def save_split_action_dict(split_dict: dict, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(split_dict, f)
