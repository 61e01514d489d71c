"""The kernel-ablation tool (`nl_vsgg_tpu_torch.tools.kernel_variants`) on
the CPU: every variant's text edit still applies to the committed kernel
source (the tool refuses a variant that would silently time the unchanged
kernel), and without a GPU the tool raises instead of timing anything."""

import pytest

from nl_vsgg_tpu_torch.tools import kernel_variants as kv


@pytest.mark.parametrize("name", sorted(kv.VARIANTS))
def test_every_variant_edits_the_committed_source(name):
    srcs = kv.variant_sources(name)
    assert set(srcs) == set(kv.VARIANTS[name])
    kernel = srcs.pop("kernel")
    for key, text in srcs.items():
        assert text != kernel, key
    assert len(set(srcs.values())) == len(srcs)


def test_variants_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        kv.run(device="cpu")


@pytest.mark.parametrize("name", sorted(kv.VARIANTS))
def test_every_text_edit_changes_its_source(name):
    """Each literal edit of a variant (the forward, dK/dV and dQ ones edit
    several kernels at once) changes the committed source on its own, so
    no kernel of a variant is timed unchanged."""
    import os
    with open(os.path.join(kv._build.CSRC, name + ".cu")) as f:
        src = f.read()
    for key, edit in kv.VARIANTS[name].items():
        for old, new in getattr(edit, "pairs", ()):
            assert old in src and src.replace(old, new) != src, (key, old)


def test_a_stale_edit_is_refused():
    edit = kv._edits(("no such text", "x"))
    with pytest.raises(RuntimeError, match="no longer applies"):
        edit("int main() {}")
