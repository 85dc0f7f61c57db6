"""The kernel build (``paddle_tpu_torch/kernels/_build.py``) without a
card: libraries are named by a hash of source and flags under the
ignored ``build/`` directory, and a failed compile raises with the
compiler's output and leaves no library behind (it never degrades to a
plain version)."""
import pathlib

import pytest

from paddle_tpu_torch.core import enforce as TE
from paddle_tpu_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_library_path_is_per_source_digest_under_build():
    paths = {n: _build.library_path(n) for n in _build.SOURCES}
    assert set(paths) == {"flash_fwd", "flash_bwd", "paged_decode",
                          "rms_norm"}
    for name, p in paths.items():
        assert p.parent == REPO / "build" / "kernels"
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
        assert (_build.CSRC / _build.SOURCES[name]).is_file()
    assert len(set(paths.values())) == 4


def test_failed_compile_raises_and_leaves_nothing(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA\n")
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "SOURCES", {"broken": "broken.cu"})
    # a stand-in compiler that fails like nvcc does: message and exit 1
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'broken.cu(1): error: syntax'\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(TE.UnavailableError, match="error: syntax"):
        _build.build_all()
    assert list(out.iterdir()) == []
    with pytest.raises(TE.UnavailableError):
        _build.load("broken")
