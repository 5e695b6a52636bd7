"""bench.py's orchestration: sequential subprocess phases, one JSON
line, failed phases reported as failed. The phase runner is
monkeypatched; _run_phase itself runs tiny real subprocesses."""

import importlib.util
import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def bench(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delenv("BENCH_SKIP_PHASES", raising=False)
    return mod


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _fake_phase(cmd, timeout, extra_env=None):
    joined = " ".join(cmd)
    if "streaming_wall" in joined:
        return {"value": 31.0, "chunk": 32, "keyframes": 60,
                "loop_closures": 15, "platform": "gpu"}
    if "sweep_throughput" in joined:
        return {"value": 900.0, "median_err_t": 0.01, "platform": "gpu"}
    det = (extra_env or {}).get("BENCH_DETECTOR")
    return {"value": 240.0 if det == "GFTT" else 139.0, "platform": "gpu",
            "device_kind": "NVIDIA H100 80GB HBM3", "first_step_s": 40.0}


def test_all_phases_reported(bench, capsys, monkeypatch):
    calls = []

    def phase(cmd, timeout, extra_env=None):
        calls.append(cmd)
        return _fake_phase(cmd, timeout, extra_env)

    monkeypatch.setattr(bench, "_run_phase", phase)
    assert bench.orchestrate() == 0
    out = _line(capsys)
    assert len(calls) == 4
    assert out["value"] == 240.0 and out["sift_fps"] == 139.0
    assert out["streaming_wall_fps"] == 31.0
    assert out["streaming_chunk"] == 32
    assert out["sweep_pairs_per_s"] == 900.0
    assert out["failed_phases"] == []
    assert out["platform"] == "gpu"
    assert out["device_kind"] == "NVIDIA H100 80GB HBM3"


def test_failed_phase_reported_as_failed(bench, capsys, monkeypatch):
    def phase(cmd, timeout, extra_env=None):
        if "streaming_wall" in " ".join(cmd):
            return None
        return _fake_phase(cmd, timeout, extra_env)

    monkeypatch.setattr(bench, "_run_phase", phase)
    assert bench.orchestrate() == 1
    out = _line(capsys)
    assert out["failed_phases"] == ["streaming"]
    assert out["streaming_wall_fps"] is None
    assert out["value"] == 240.0


def test_skip_phases(bench, capsys, monkeypatch):
    monkeypatch.setenv("BENCH_SKIP_PHASES", "step_sift,sweep")
    assert [p[0] for p in bench.phases()] == ["step_gfft", "streaming"]
    monkeypatch.setattr(bench, "_run_phase", _fake_phase)
    assert bench.orchestrate() == 0
    out = _line(capsys)
    assert out["sift_fps"] is None and out["failed_phases"] == []


@pytest.mark.parametrize("src,expect", [
    ("print('noise'); print('{\"value\": 3.5}')", {"value": 3.5}),
    ("print('{\"value\": 1}'); raise SystemExit(2)", None),
    ("print('no json here')", None),
])
def test_run_phase_reads_last_json_line(bench, src, expect):
    assert bench._run_phase([sys.executable, "-c", src], 60) == expect


def test_run_phase_timeout_is_failure(bench):
    src = "import time; time.sleep(30)"
    assert bench._run_phase([sys.executable, "-c", src], 0.5) is None
