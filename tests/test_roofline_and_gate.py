"""Unit tests: roofline accounting + release-gate row comparison +
serve-app smoke run."""

import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import pytest

from rtmpc_tpu.parallel.roofline import (admm_engine_model, device_peaks,
                                         roofline_summary, solve_arithmetic)


class _Dev:
    """Stands in for a ``jax.Device``: only ``device_kind`` is read."""

    def __init__(self, kind):
        self.device_kind = kind


def test_device_peaks_h100_lookup():
    peaks = device_peaks(_Dev("NVIDIA H100 80GB HBM3"))
    assert (peaks.bf16_tflops, peaks.tf32_tflops, peaks.f32_tflops,
            peaks.hbm_gbps) == (989.0, 495.0, 67.0, 3350.0)
    assert "data sheet" in peaks.source
    # the kind string itself works as well as a device
    assert device_peaks("NVIDIA H100 80GB HBM3") == peaks


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_device_peaks_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(_Dev(kind))


def test_engine_model_consistency():
    m = admm_engine_model(n=40, m=112, ntheta=4, iters_total=120,
                          T=120, batch=16384)
    # matmul FLOPs: T * (iters * 2B(2mn+n^2) + per-solve terms)
    per_iter = 2 * 16384 * (2 * 112 * 40 + 40 * 40)
    assert m["flops"] > 120 * 120 * per_iter
    # least bytes: per step the state goes in and out once
    assert m["bytes_min"] > 120 * 2 * 4 * 16384 * (40 + 2 * 112)


@pytest.mark.parametrize("solver,precision,want", [
    ("admm", "high", "f32"),        # XLA runs HIGHEST under either name
    ("admm", "highest", "f32"),
    ("ip_hybrid", "high", "f32"),
    ("pallas", "high", "bf16x3"),   # only the kernel splits into bf16
    ("pallas", "highest", "f32"),
])
def test_solve_arithmetic(solver, precision, want):
    assert solve_arithmetic(solver, precision) == want


def test_solve_arithmetic_rejects():
    with pytest.raises(ValueError):
        solve_arithmetic("admm", "default")
    with pytest.raises(ValueError):
        solve_arithmetic("admm", "high", "float64")


def test_roofline_bound_naming():
    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    m = admm_engine_model(40, 112, 4, 120, 120, 16384)
    # the shipped default: the XLA solver at "high" runs IEEE f32
    s = roofline_summary(m, wall_s=0.75, peaks=peaks,
                         arithmetic=solve_arithmetic("admm", "high"))
    # ~2.5e12 FLOPs at 67 TFLOP/s outweigh ~1 GB at 3.35 TB/s
    assert s["roofline_bound"] == "compute"
    t_compute = m["flops"] / (peaks.f32_tflops * 1e12)
    assert s["roofline_share"] == pytest.approx(t_compute / 0.75)
    assert s["peaks"]["matmul_tflops"] == pytest.approx(67.0)
    # the kernel's 3-pass bf16 runs on the tensor cores: the higher peak
    s3 = roofline_summary(m, wall_s=0.75, peaks=peaks,
                          arithmetic=solve_arithmetic("pallas", "high"))
    assert s3["peaks"]["matmul_tflops"] == pytest.approx(989.0 / 3)
    assert s3["roofline_share"] < s["roofline_share"]
    # one iteration per step at batch 1: memory-bound
    m1 = admm_engine_model(40, 112, 4, 1, 120, 1)
    assert roofline_summary(m1, 1.0, peaks, "bf16x3")["roofline_bound"] \
        == "memory"
    with pytest.raises(ValueError):
        roofline_summary(m, 0.75, peaks, "tf32")


def test_release_gate_compare_rows(tmp_path):
    from release_gate import compare_linear

    rows_cpu = [{"p": 0.1 * i, "rms_tube": 0.02 + 0.001 * i,
                 "rms_track": 0.03 + 0.002 * i,
                 "rms_tube_median": 0.019 + 0.001 * i,
                 "rms_track_median": 0.029 + 0.002 * i,
                 "track_infeasible": 0}
                for i in range(10)]
    base = {"n_mc": 20, "T": 250, "seed": 0, "rows": rows_cpu}
    cpu = tmp_path / "cpu.json"
    cpu.write_text(json.dumps(base))

    # within 2% on gated stats: passes
    rows_dev = [dict(r, rms_tube=r["rms_tube"] * 1.015,
                     rms_track=r["rms_track"] * 0.99) for r in rows_cpu]
    dev = tmp_path / "dev.json"
    dev.write_text(json.dumps(dict(base, rows=rows_dev)))
    ok, msg = compare_linear(str(dev), str(cpu))
    assert ok, msg

    # the track MEAN is informational, not gated (knife-edge outlier runs)
    rows_meanoff = [dict(r) for r in rows_dev]
    rows_meanoff[8]["rms_track"] = rows_cpu[8]["rms_track"] * 2.5
    dev.write_text(json.dumps(dict(base, rows=rows_meanoff)))
    ok, msg = compare_linear(str(dev), str(cpu))
    assert ok and "info" in msg

    # but the track MEDIAN is gated
    rows_medoff = [dict(r) for r in rows_dev]
    rows_medoff[8]["rms_track_median"] = \
        rows_cpu[8]["rms_track_median"] * 1.1
    dev.write_text(json.dumps(dict(base, rows=rows_medoff)))
    ok, msg = compare_linear(str(dev), str(cpu))
    assert not ok

    # 5% off on one row: fails
    rows_bad = [dict(r) for r in rows_dev]
    rows_bad[3]["rms_tube"] = rows_cpu[3]["rms_tube"] * 1.05
    dev.write_text(json.dumps(dict(base, rows=rows_bad)))
    ok, msg = compare_linear(str(dev), str(cpu))
    assert not ok and "FAIL" in msg

    # NaN truth rows (stopped arm) are skipped, not compared
    rows_nan = [dict(r, rms_track=float("nan")) for r in rows_cpu]
    cpu.write_text(json.dumps(dict(base, rows=rows_nan)))
    dev.write_text(json.dumps(dict(base, rows=rows_dev)))
    ok, _ = compare_linear(str(dev), str(cpu))
    assert ok

    # config mismatch is a hard failure
    cpu.write_text(json.dumps(dict(base, n_mc=5)))
    ok, msg = compare_linear(str(dev), str(cpu))
    assert not ok and "mismatch" in msg


def test_serve_controller_smoke(capsys):
    """The deployment demo runs end-to-end (tiny session, CPU)."""
    from rtmpc_tpu.apps.serve_controller import main

    rc = main(["--ticks", "300", "--window", "150",
               "--per-dispatch-ticks", "10"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "device-resident session" in out
    assert out.count("[PASS]") == 4
