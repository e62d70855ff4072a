"""The kernel libraries' build identity (``kernels/build.py``), on the CPU.

A library's file name and the stamp on its kernels' tune records are
``build.digest``: a hash of its ``.cu`` source, every ``csrc`` header the
source includes (directly or through another header), and the nvcc flags.
An edited header must therefore name a new library, or a stale one would
load and its tune records would pass as current.
"""

import pytest

from repro_torch.kernels import build


def _csrc(tmp_path, monkeypatch, files):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in files.items():
        (csrc / name).write_text(text)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "_DIGESTS", {})
    return csrc


FILES = {"k.cu": '#include <stdint.h>\n#include "a.cuh"\nint f();\n',
         "a.cuh": '#pragma once\n#  include "b.cuh"\n',
         "b.cuh": "#pragma once\nint g();\n",
         "other.cuh": "int h();\n"}


def test_sources_follow_the_includes_of_csrc_headers(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch, FILES)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited, changes", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("other.cuh", False)])
def test_editing_an_included_header_changes_the_digest(tmp_path, monkeypatch,
                                                       edited, changes):
    csrc = _csrc(tmp_path, monkeypatch, FILES)
    before = build.digest("k")
    (csrc / edited).write_text(FILES[edited] + "// edited\n")
    monkeypatch.setattr(build, "_DIGESTS", {})
    after = build.digest("k")
    assert (after != before) == changes
    assert build.library_path("k").name == f"libk_{after}.so"


def test_the_hopper_kernels_share_one_header():
    for name in ("ert", "flash"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu",
                                                         "hopper.cuh"]
    for name in ("fused", "ssd"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu"]
