"""The port's CUDA sources and where they build, with no list of them to
keep: every ``csrc/*.cu`` is a source of its own library, each library
and its ``nvcc`` log land under the package's ``build/`` directory,
which ``.gitignore`` lists, and an edit to any source moves the build to
a new directory (so a stale library is never loaded).  Runs on the CPU:
nothing is compiled here.
"""

import shutil
from pathlib import Path

import pytest

from horovod_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


def _on_disk():
    return sorted(_build.CSRC.glob("*.cu"))


def test_every_cuda_source_is_built():
    assert _on_disk() and list(_build.sources()) == _on_disk()


@pytest.mark.parametrize("src", _on_disk(), ids=lambda p: p.name)
def test_each_library_builds_into_the_ignored_directory(src):
    """``lib<name>.so`` and ``<name>.log`` sit under a ``build/``
    directory of the package, and ``.gitignore`` lists it (and both
    suffixes besides)."""
    ignored = set((REPO / ".gitignore").read_text().split())
    for made in ("lib%s.so" % src.stem, "%s.log" % src.stem):
        rel = (_build.build_dir() / made).relative_to(REPO)
        assert rel.parts[:2] == ("horovod_tpu_torch", "build")
        assert len(rel.parts) == 4  # build/<digest>/<file>
    assert {"build/", "*.so", "*.log"} <= ignored


def test_an_edited_source_builds_elsewhere(tmp_path, monkeypatch):
    for src in _on_disk():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.build_dir()
    assert first == _build.build_dir()
    edited = tmp_path / _on_disk()[0].name
    edited.write_bytes(edited.read_bytes() + b"\n")
    assert _build.build_dir() != first
    assert _build.build_dir().parent == _build.BUILD_ROOT
