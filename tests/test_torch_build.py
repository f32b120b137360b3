"""The kernel build of daclip_torch (ops/_build.py) on the CPU: every header
a CUDA source includes is hashed into the library's name, so an edit to a
shared header (common.cuh, mma.cuh, linattn_tiles.cuh) rebuilds the kernels
that include it; every exported launcher's C parameters match the ctypes
signature `_build.SIGNATURES` binds it with."""
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
    # the tensor-core kernels take their PTX from mma.cuh; both flash kernels
    # their tiles from flash_tiles.cuh
    for src in ("conv3x3.cu", "flash_attention_bwd.cu", "flash_attention.cu", "pointwise.cu"):
        assert (src, "mma.cuh") in found, src
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert (src, "flash_tiles.cuh") in found, src
    # both linear-attention kernels take their tensor-core tiles from
    # linattn_tiles.cuh, which takes its PTX from mma.cuh
    for src in ("linear_attention.cu", "linear_attention_bwd.cu"):
        assert (src, "linattn_tiles.cuh") in found, src
    assert ("linattn_tiles.cuh", "mma.cuh") in found
    for src, name in found:
        assert name in hashed, f"{src} includes {name}, which _build._sources() does not hash"


@pytest.mark.parametrize("name", ["mma.cuh", "common.cuh", "conv3x3.cu", "flash_tiles.cuh",
                                  "linattn_tiles.cuh"])
def test_an_edit_to_a_source_changes_the_digest(tmp_path, monkeypatch, name):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build._digest()
    assert _build._digest() == before  # stable
    with open(copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build._digest() != before


_CTYPES = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
           "long": _build._L, "float": _build._F}


def _launchers(src):
    """(name, [ctypes type of each parameter]) of every `extern "C"` launcher
    defined in src."""
    text = (_build.CSRC / src).read_text()
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', text):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split())
            kind = decl.rsplit(" ", 1)[0].replace(" *", "*")
            types.append(_CTYPES[kind])
        yield name, types


@pytest.mark.parametrize("src", ["linear_attention.cu", "linear_attention_bwd.cu",
                                 "flash_attention.cu", "flash_attention_bwd.cu",
                                 "pointwise.cu", "conv3x3.cu"])
def test_every_launcher_matches_its_ctypes_signature(src):
    found = dict(_launchers(src))
    assert found, f"no extern \"C\" launcher found in {src}"
    for name, types in found.items():
        assert name in _build.SIGNATURES, f"{src}: {name} has no ctypes signature"
        assert _build.SIGNATURES[name] == types, f"{src}: {name} takes {types}"
    # the two linear-attention files export exactly these launchers
    want = {"linear_attention.cu": {"daclip_wrap_stats", "daclip_wrap_combine",
                                    "daclip_wrap_apply", "daclip_linattn_fused_v4",
                                    "daclip_linattn_core"},
            "linear_attention_bwd.cu": {"daclip_wrap_bwd1", "daclip_wrap_bwd_mid",
                                        "daclip_wrap_bwd2", "daclip_wrap_wgrad"}}
    if src in want:
        assert set(found) == want[src]
