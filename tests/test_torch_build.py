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
