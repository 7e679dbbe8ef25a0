"""The native LP library is built from the tracked sources at first use, and
when it cannot be, the scipy fallback says why."""

import os
import shutil

import pytest

from rtmpc_tpu.utils import _native


def _fresh(monkeypatch, native_dir):
    """Point the loader at ``native_dir`` as if nothing had been loaded."""
    monkeypatch.setattr(_native, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(_native, "_SRC", str(native_dir / "rtmpc_lp.cpp"))
    monkeypatch.setattr(_native, "_SO", str(native_dir / "librtmpc_lp.so"))
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_why", "")


def _copy_sources(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "rtmpc_lp.cpp"):
        shutil.copy(os.path.join(_native._REPO_ROOT, "native", name), d)
    return d


def test_opt_out_is_named(monkeypatch, tmp_path):
    _fresh(monkeypatch, _copy_sources(tmp_path))
    monkeypatch.setenv("RTMPC_NO_NATIVE", "1")
    assert not _native.native_available()
    assert _native.native_status() == "scipy (RTMPC_NO_NATIVE is set)"


def test_build_failure_is_reported(monkeypatch, tmp_path):
    d = _copy_sources(tmp_path)
    (d / "Makefile").write_text("all:\n\t@echo no compiler here >&2; exit 1\n")
    _fresh(monkeypatch, d)
    monkeypatch.delenv("RTMPC_NO_NATIVE", raising=False)
    with pytest.warns(RuntimeWarning, match="no compiler here"):
        assert not _native.native_available()
    assert _native.native_status().startswith("scipy (make failed:")


@pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                    reason="needs make and g++")
def test_builds_from_tracked_sources(monkeypatch, tmp_path):
    """A checkout holds only the tracked Makefile and source: the first
    use builds the library there and loads it."""
    d = _copy_sources(tmp_path)
    _fresh(monkeypatch, d)
    monkeypatch.delenv("RTMPC_NO_NATIVE", raising=False)
    assert _native.native_status() == "native"
    assert (d / "librtmpc_lp.so").exists()
