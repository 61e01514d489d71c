"""The model axis keeps one copy of the replicated state
(parallel/tensor.broadcast_grads, called by train/step.make_train_step).

The ranks of a model group compute the parameters that the model axis does
not shard from the same bits, but a kernel that sums in no fixed order
(the card's atomics, threaded CPU kernels under load) can round a
replicated gradient apart on one rank; chip_smoke.py phase 19's CPU test
(tests/test_torch_multicard.py) saw the ranks of a 1 x 4 mesh end a step
with different states. Here 2 gloo ranks at mesh 1 x 2 take an AdamW step
of a narrow STTran with one replicated parameter's gradient nudged by 1e-6
on the second rank alone: the gradient broadcast from the first rank
leaves both ranks with one state.
"""

from __future__ import annotations

import numpy as np
import torch

from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from tests._torch_dist_worker import model_recipe, run_job

NUDGED = "a_rel_compress.weight"       # 1936 -> 3: too narrow for the model axis to shard


def test_replicas_stay_one_after_a_gradient_rounds_apart(tmp_path):
    rng = np.random.default_rng(20)
    entries = [make_synthetic_entry(rng, n_frames=4, objs_per_frame=3, bucket_boxes=16,
                                    bucket_rels=12, feat_dim=64) for _ in range(2)]
    torch.save({}, tmp_path / "refs.pt")
    case = {"model": model_recipe("STTran", 21, mode="sgdet", feat_dim=64, dec_layer_num=1,
                                  dropout=0.0),
            "opt": "adamw", "lr": 1e-3, "batches": [entries], "refs": [{}],
            "nudge_param": NUDGED}
    res = run_job("tp", tmp_path, 2, {"data": 1, "model": 2, "refs": str(tmp_path / "refs.pt"),
                                      "cases": {"nudge": case}}, threads=2)
    assert [r["mesh"][:2] for r in res] == [(0, 0), (0, 1)]
    a, b = (r["nudge"] for r in res)
    assert a["digests"][0] == b["digests"][0]
    assert (a["skipped"], a["step"]) == (0, 1)
    assert a["comm"]["broadcasts"] >= 1 and a["comm"]["broadcast_bytes"] > 0
