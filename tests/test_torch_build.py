"""ops/_build.py names each kernel library by everything it is built from.

No compiler runs here: the tests point the module at a temporary source
directory and look at the names it would build."""
import pytest

from semanticsearch_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "alpha.cu").write_text('#include "shared.cuh"\nint alpha;\n')
    (src / "beta.cu").write_text("int beta;\n")
    (src / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    return src


def test_sources_lists_only_cu_files(csrc):
    assert _build.sources() == ["alpha", "beta"]


def test_target_changes_with_its_source_only(csrc):
    a, b = _build._target("alpha"), _build._target("beta")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libalpha-")
    assert a == _build._target("alpha")
    (csrc / "alpha.cu").write_text("int alpha2;\n")
    assert _build._target("alpha") != a
    assert _build._target("beta") == b


@pytest.mark.parametrize("change", ["edit", "add", "rename"])
def test_target_changes_when_a_header_changes(csrc, change):
    before = {n: _build._target(n) for n in _build.sources()}
    if change == "edit":
        (csrc / "shared.cuh").write_text("// v2\n")
    elif change == "add":
        (csrc / "other.cuh").write_text("// v1\n")
    else:
        (csrc / "shared.cuh").rename(csrc / "moved.cuh")
    after = {n: _build._target(n) for n in _build.sources()}
    assert _build.sources() == ["alpha", "beta"]
    assert all(after[n] != before[n] for n in before)


def test_target_changes_with_the_flags(csrc, monkeypatch):
    before = _build._target("alpha")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._target("alpha") != before


def test_the_real_sources_include_the_shared_main_loop():
    names = _build.sources()
    assert {"segtopk", "topk_fused", "flash_attention", "similarity"} <= set(names)
    assert "qc_mainloop" not in names
    for name in ("segtopk", "topk_fused"):
        text = (_build._CSRC / f"{name}.cu").read_text()
        assert '#include "qc_mainloop.cuh"' in text
        assert "qc::consume" in text and "qc::produce" in text
