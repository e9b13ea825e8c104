"""The per-layer readers and the frozen roofline formulas on known
shapes, and the window arithmetic of sample_s."""

import json
import subprocess
import sys

import pytest

from hlabench import harness, spec, trace
from tiny import REPO


def reader(name):
    return spec.Bench(REPO).reader(name)


def test_k1_bound_on_the_main_shape():
    k1 = spec.roofline("k1")
    B, L, W = 65536, 101, 32
    n_bytes = B * (L + 4 + L + W + 12 + (L + 1) * W)
    assert k1.bound_s(B, L, W) == pytest.approx(n_bytes / 3.35e12)
    assert k1.bound_s(8, 1000, 2) == pytest.approx(
        8 * (1000 + 4 + 1002 + 12 + 1001 * 2) / 3.35e12)


def test_k3_bound_at_imgt_width_is_the_special_function_bound():
    k3 = spec.roofline("k3")
    C, R, sms, mhz = 2200, 16460, 132, 1980.0
    cells = C * (C + 1) // 2 * R
    assert k3.bound_s(C, R, sms, mhz) == pytest.approx(
        2 * cells / (16 * sms * mhz * 1e6))
    assert k3.bound_s(2, 1, sms, mhz) == pytest.approx(
        4 * (2 + 4) / 3.35e12)


def test_roofline_readers_sum_bounds_over_device_seconds():
    k1, k3 = spec.roofline("k1"), spec.roofline("k3")
    rec = {"launches": {"K1": [(100, 101, 32, 1e-3), (50, 101, 32, 1e-3)],
                        "K3": [(12, 900, None, 1e-4), (12, 900, (0, 1), 1)]},
           "sm_count": 132, "max_sm_mhz": 1980.0}
    got = reader("k1.roofline_pct").read(rec)
    assert got == pytest.approx(100 * (k1.bound_s(100, 101, 32)
                                       + k1.bound_s(50, 101, 32)) / 2e-3)
    got = reader("k3.roofline_pct").read(rec)
    assert got == pytest.approx(100 * k3.bound_s(12, 900, 132, 1980.0)
                                / 1e-4)
    assert reader("k1.roofline_pct").read({"launches": {}}) is None


def test_span_readers_and_idle_share():
    rec = {"samples": [
        {"ok": True, "wall_s": 10.0, "align_s": 3.0, "type_s": 5.0},
        {"ok": True, "wall_s": 12.0, "align_s": 4.0, "type_s": 6.0},
        {"ok": False, "wall_s": 1.0, "align_s": None, "type_s": None}],
        "busy_s": 0.5, "window_s": 20.0}
    assert reader("pipeline.rest_s").read(rec) == pytest.approx(2.0)
    assert reader("aligner.align_s").read(rec) == pytest.approx(3.5)
    assert reader("typer.type_s").read(rec) == pytest.approx(5.5)
    assert reader("device.idle_pct").read(rec) == pytest.approx(97.5)
    assert reader("device.idle_pct").read({"busy_s": 0,
                                           "window_s": 1}) is None


def test_sample_s_is_the_window_over_the_samples_completed():
    e = harness.end_to_end(45.0, 4, 31.5)
    assert e == {"sample_s": 11.25, "setup_s": 31.5}
    assert harness.end_to_end(45.0, 0, 31.5)["sample_s"] is None


def test_busy_seconds_merge_overlaps_and_clip_to_the_window():
    ev = [(0.5, 1.5, "a"), (1.0, 2.0, "b"), (3.0, 4.0, "a"), (9, 12, "c")]
    assert trace.busy_s(ev, 1.0, 10.0) == pytest.approx(1.0 + 1.0 + 1.0)
    ops = trace.device_ops(ev)
    assert ops[0] == ["c", 3] and ops[1] == ["a", 2.0]
    gaps = trace.idle_gaps(ev, 0.0, 10.0,
                           [(0.0, 5.0, "align"), (5.0, 10.0, "type")])
    assert gaps[0] == ["type", 5.0] and gaps[1] == ["align", 1.0]


def test_k2_bound_is_chip_smokes_nw_bound_at_its_k2_rows():
    """PERF.md's kernel table, rows (h), (y) and (aa): chip_smoke.py's
    nw_bound, read in a process of its own (chip_smoke blocks jax in
    sys.modules when it is imported)."""
    shapes = [(838, 10_000, 256), (32, 50_000, 256), (310, 2_273, 256)]
    code = ("import json, chip_smoke\n"
            f"print(json.dumps([chip_smoke.nw_bound(*s)['bound_ms'] "
            f"for s in {shapes!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO, check=True)
    want = json.loads(out.stdout.splitlines()[-1])
    k2 = spec.roofline("k2")
    assert [1e3 * k2.bound_s(*s) for s in shapes] == pytest.approx(
        want, rel=1e-12)
    # PERF.md's bounds of those rows, in ms
    assert want == pytest.approx([0.6455, 0.1232, 0.0543], abs=5e-5)
    assert k2.bound_s(5, 1_000, 33) == spec.roofline("k1").bound_s(
        5, 1_000, 33)

