"""CPU tests of ``chip_smoke.py``'s contract and the compile-cache helper.

The phases themselves need the card; here: the device phase refuses the
CPU, the last line's exact schema, the phase selection of ``--four-cards``,
and where the persistent compilation cache goes.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
from rtmpc_tpu.utils import compile_cache  # noqa: E402


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_device_phase_fails_on_cpu():
    with pytest.raises(chip_smoke.PhaseFailed, match="no GPU"):
        chip_smoke.phase_device(jax, 1)


def test_script_exits_nonzero_without_gpu():
    out = _run_script(os.path.join(_ROOT, "chip_smoke.py"), _ROOT)
    assert out.returncode != 0
    assert "no GPU" in out.stdout
    assert '"ok"' not in out.stdout


def test_script_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_last_line_schema():
    line = chip_smoke.final_line("NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_four_cards_selects_only_its_phases():
    assert chip_smoke.select_phases(True) == ("device", "sharded",
                                              "multichip")
    one = chip_smoke.select_phases(False)
    assert one[0] == "device" and "sharded" not in one \
        and "multichip" not in one
    assert set(one) | {"sharded", "multichip"} == set(chip_smoke.PHASES)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing else is set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable_compile_cache()
        assert d == os.path.join(_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert compile_cache.enable_compile_cache() == d     # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
