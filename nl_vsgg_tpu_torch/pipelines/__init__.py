"""The offline label pipeline: caption segmentation (tcs), LLM triplet
parsing (triplets), CLIP (clip, tokenizer) and caption-frame alignment
(adv), motion-cue negatives (negatives), and the LLM prompts (prompts)."""

from . import adv, clip, negatives, tcs, tokenizer, triplets

__all__ = ["adv", "clip", "negatives", "tcs", "tokenizer", "triplets"]
