"""``run.py`` where it must print no result: no card, or no port."""

import json
import os
import shutil
import subprocess
import sys

import torch

from harness import runner
from harness.spec import BENCH_DIR, ROOT, Cell


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "disco_1024x768.preview", "--seed", str(2**31 + 3), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA card" in proc.stderr


def test_with_only_the_benchmarks_files_it_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_run_on_the_cpu_never_names_a_device(capsys):
    cell = Cell("disco_1024x768.preview")
    cell.config.update(width=16, height=8)
    cell.traffic.update(check_from=4)
    assert runner.run(cell, 11, 0.1, False, torch.device("cpu"), 0.0) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["device"]["platform"] == "cpu" and result["device"]["kind"] == "cpu"
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
