"""The kernel build cache key: a library is named by the content of its
``csrc`` source and of every header that source includes, so an edited
header is rebuilt and never loaded stale.  Runs without nvcc (it only
computes paths)."""
import shutil

import pytest

from deeplearning4j_tpu_torch.utils import kernel_build as kb


def test_the_flash_kernels_include_the_shared_header():
    assert kb.sources_of("flash_attn_fwd.cu") == ["flash_attn_fwd.cu",
                                                  "flash_common.cuh"]
    assert kb.sources_of("flash_attn_bwd.cu") == ["flash_attn_bwd.cu",
                                                  "flash_common.cuh"]
    assert kb.sources_of("bn_apply.cu") == ["bn_apply.cu"]


@pytest.mark.parametrize("source", ["flash_attn_fwd.cu", "flash_attn_bwd.cu"])
def test_editing_a_header_changes_the_library_path(tmp_path, source):
    csrc = tmp_path / "csrc"
    shutil.copytree(kb.CSRC_DIR, csrc)
    before = kb.library_path(source, csrc)
    assert before == kb.library_path(source)     # the copy is the same
    assert before.name.startswith(source.split(".")[0] + "-")
    untouched = kb.library_path("bn_apply.cu", csrc)

    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = kb.library_path(source, csrc)
    assert after != before
    # a source that does not include the header keeps its library
    assert kb.library_path("bn_apply.cu", csrc) == untouched

    # a header reached through another header counts too
    (csrc / "inner.cuh").write_text("// inner\n")
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    nested = kb.library_path(source, csrc)
    assert "inner.cuh" in kb.sources_of(source, csrc)
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert kb.library_path(source, csrc) != nested
