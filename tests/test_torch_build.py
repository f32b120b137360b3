"""The kernel build of daclip_torch (ops/_build.py) on the CPU: every header
a CUDA source includes is hashed into the library's name, so an edit to a
shared header (common.cuh, mma.cuh) rebuilds the kernels that include it."""
import re
import shutil

import pytest

from daclip_torch.ops import _build


def _includes():
    for src in sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh")):
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(), re.M):
            yield src.name, name


def test_every_quoted_include_is_a_hashed_source():
    hashed = {p.name for p in _build._sources()}
    found = list(_includes())
    assert ("conv3x3.cu", "mma.cuh") in found and ("flash_attention_bwd.cu", "mma.cuh") in found
    for src, name in found:
        assert name in hashed, f"{src} includes {name}, which _build._sources() does not hash"


@pytest.mark.parametrize("name", ["mma.cuh", "common.cuh", "conv3x3.cu"])
def test_an_edit_to_a_source_changes_the_digest(tmp_path, monkeypatch, name):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build._digest()
    assert _build._digest() == before  # stable
    with open(copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build._digest() != before
