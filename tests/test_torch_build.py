"""The port's native build and launch bookkeeping (kernels/_build.py), on the
host library: a failed compile raises (no silent fallback), an edited source
gets a new library, and a launch is counted only when it succeeded."""
import pytest

from garmentnets_tpu_torch.kernels import _build


@pytest.fixture
def scratch_pkg(tmp_path, monkeypatch):
    """_build pointed at a scratch package copy holding only marching.cpp."""
    (tmp_path / "ops" / "cpp").mkdir(parents=True)
    src = tmp_path / "ops" / "cpp" / "marching.cpp"
    monkeypatch.setattr(_build, "PKG_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    return src


def test_failed_build_raises_and_leaves_nothing(scratch_pkg):
    scratch_pkg.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building marching failed"):
        _build.load("marching")
    assert not any((_build.BUILD_DIR).glob("*.so"))
    assert "marching" not in _build._LIBS


def test_edited_source_gets_a_new_library(scratch_pkg):
    scratch_pkg.write_text('extern "C" int f() { return 1; }\n')
    assert _build.load("marching").f() == 1
    first = sorted(_build.BUILD_DIR.glob("*.so"))
    scratch_pkg.write_text('extern "C" int f() { return 2; }\n')
    _build._LIBS.clear()
    assert _build.load("marching").f() == 2
    second = sorted(_build.BUILD_DIR.glob("*.so"))
    assert len(first) == 1 and len(second) == 2


def test_launch_counted_only_on_success(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", {"fps": 0})
    _build.check_launch("fps", 0)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        _build.check_launch("fps", 1)
    assert _build.LAUNCHES["fps"] == 1
    _build.reset_launch_counts()
    assert _build.LAUNCHES["fps"] == 0


def test_edited_header_gets_new_cuda_libraries(tmp_path, monkeypatch):
    """A CUDA library's name hashes the headers in csrc/ too, so editing a
    shared header (wgmma_common.cuh) rebuilds every kernel that may
    include it; the host library does not depend on them."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    header = csrc / "common.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    _, first = _build._target("k")
    _, marching = _build._target("marching")
    header.write_text("// two\n")
    assert _build._target("k")[1] != first
    assert _build._target("marching")[1] == marching
    assert "sa_tc" in _build.CUDA_SOURCES and "sa" not in _build.CUDA_SOURCES
