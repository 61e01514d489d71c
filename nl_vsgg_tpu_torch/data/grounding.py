"""The evaluator's input builders (from nl_vsgg_tpu/data/grounding.py).

Only `entry_to_eval_pred` and `entry_to_pred` are ported so far; the rest
of grounding (pseudo-label assignment, `wk_forward`) arrives with the host
data engine. Both return host numpy: Entry fields and model outputs may be
tensors on any device, floating ones in bfloat16 (`to_numpy` casts them to
float32).
"""

from __future__ import annotations

from .entry import Entry, to_numpy


def entry_to_eval_pred(entry: Entry, pred: dict) -> dict:
    """Model outputs + the Entry fields the evaluator needs, as host numpy.

    One definition for every eval path (epoch eval, sgdet and sgcls test
    flows), so the evaluator's input cannot diverge between them."""
    out = {k: to_numpy(v) for k, v in pred.items()}
    out.update(boxes=to_numpy(entry.boxes),
               pair_idx=to_numpy(entry.pair_idx),
               im_idx=to_numpy(entry.im_idx),
               rel_mask=to_numpy(entry.rel_mask),
               box_mask=to_numpy(entry.box_mask),
               labels=to_numpy(entry.labels),
               scores=to_numpy(entry.scores))
    return out


def entry_to_pred(entry: Entry | None) -> dict:
    """Oracle-detector pred from the Entry's GT relation labels."""
    if entry is None:
        return {}
    return {
        "boxes": to_numpy(entry.boxes),
        "box_mask": to_numpy(entry.box_mask),
        "labels": to_numpy(entry.labels),
        "scores": to_numpy(entry.scores),
        "pred_labels": to_numpy(entry.labels),
        "pred_scores": to_numpy(entry.scores),
        "pair_idx": to_numpy(entry.pair_idx),
        "im_idx": to_numpy(entry.im_idx),
        "rel_mask": to_numpy(entry.rel_mask),
        # attention goes through softmax in the evaluator; huge logits on the
        # GT bits reproduce the reference's exact one-hot probabilities
        "attention_distribution": to_numpy(entry.attention_gt) * 1e4,
        "spatial_distribution": to_numpy(entry.spatial_gt),
        "contacting_distribution": to_numpy(entry.contacting_gt),
    }
