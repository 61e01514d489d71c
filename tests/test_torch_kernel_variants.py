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
