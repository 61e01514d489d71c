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
    no kernel of a variant is timed unchanged; an edit of a shared header
    (`tiled-1xtf32`, `tf32-1x`: csrc/mma_tf32.cuh) changes the header the
    source includes."""
    import os

    def read(fname):
        with open(os.path.join(kv._build.CSRC, fname)) as f:
            return f.read()
    src = read(name + ".cu")
    for key, edit in kv.VARIANTS[name].items():
        header = getattr(edit, "header", None)    # an edit of an included header
        text = read(header) if header else src
        if header:
            assert f'#include "{header}"' in src, (key, header)
        for old, new in getattr(edit, "pairs", ()):
            assert old in text and text.replace(old, new) != text, (key, old)


def test_a_stale_edit_is_refused():
    edit = kv._edits(("no such text", "x"))
    with pytest.raises(RuntimeError, match="no longer applies"):
        edit("int main() {}")


def test_a_header_edit_is_inlined_in_place_of_its_include():
    """`tf32-1x` and `tiled-1xtf32` build from a source in which
    csrc/mma_tf32.cuh is inlined, edited to one TF32 product a call, and no
    longer included; a source that does not include the header is
    refused."""
    assert kv.VARIANTS["grouped_conv"]["tf32-1x"] is kv.ONE_TF32
    assert kv.VARIANTS["masked_attention"]["tiled-1xtf32"] is kv.ONE_TF32
    text = kv.variant_sources("grouped_conv")["tf32-1x"]
    assert '#include "mma_tf32.cuh"' not in text
    assert "mma_tf32(d, al, bh0, bh1);" not in text and "mma_tf32(d, ah, bh0, bh1);" in text
    with pytest.raises(RuntimeError, match="no longer includes"):
        kv.ONE_TF32("int main() {}")


def test_spills_reads_the_ptxas_report():
    """`spills` names each kernel of an `nvcc -Xptxas=-v` report that spills
    to local memory, with its spill line, and no kernel that does not."""
    report = (
        "ptxas info    : Compiling entry function '_Z4slowv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4slowv\n"
        "    40 bytes stack frame, 36 bytes spill stores, 28 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Function properties for _Z4fastv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert kv.spills(report) == [
        "_Z4slowv: 40 bytes stack frame, 36 bytes spill stores, 28 bytes spill loads"]
    assert kv.spills(report.replace("36 bytes spill stores, 28", "0 bytes spill stores, 0")) == []
