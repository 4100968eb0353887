"""The kernel build's cache key (``proben_tpu_torch/_build.py``): a library
is rebuilt when its source, any local header or any flag changes. CPU only:
nothing is compiled."""

from proben_tpu_torch import _build
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)


def test_library_key_follows_sources_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int A = 1;\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first  # stable
    (tmp_path / "common.cuh").write_text("constexpr int A = 2;\n")
    after_header = _build.library_path("k")
    assert after_header != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    after_source = _build.library_path("k")
    assert after_source not in (first, after_header)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-I/some/include",))
    assert _build.library_path("k") not in (first, after_header, after_source)
    (tmp_path / "notes.txt").write_text("not a header")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    assert _build.library_path("k") == after_source  # other files do not count
