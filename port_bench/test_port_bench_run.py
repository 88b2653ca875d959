"""``run.py`` where it must print no result: no card, or no port; and the
cards a run takes, with the memory reading of the fullest."""

import json
import os
import shutil
import subprocess
import sys

import pytest
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


def test_a_one_card_cell_gets_its_device_and_a_four_card_cell_cards_0_to_3():
    device = torch.device("cuda", 0)
    assert runner.cards(Cell("box_400x400.geometry"), device) == [device]
    four = Cell("box_400x400.geometry")
    four.chips = 4
    assert runner.cards(four, device) == [torch.device("cuda", k) for k in range(4)]
    assert runner.memory_peak_bytes([torch.device("cpu")]) == 0


HOLD = 1 << 30
HOLDER = ("import sys, torch; x = torch.ones({n}, dtype=torch.uint8, device='cuda:{k}'); "
          "torch.cuda.synchronize({k}); print('held', flush=True); sys.stdin.read()")


def _held_by_another_process(card: int, cards: list) -> int:
    """``memory_peak_bytes`` of ``cards`` while a spawned process holds
    ``HOLD`` bytes on card ``card``."""
    proc = subprocess.Popen([sys.executable, "-c", HOLDER.format(n=HOLD, k=card)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "held"
        if len(cards) == 1:
            return runner.card_held_bytes(cards[0])
        return runner.memory_peak_bytes(cards)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)


@pytest.mark.cuda
@pytest.mark.parametrize("chips", [1, 4])
def test_on_the_card_the_fullest_cards_reading_counts_a_worker_processs_memory(chips):
    """The card a spawned process fills is the fullest, and its reading
    counts what that process holds though this one holds next to nothing
    there.  With one card the reading is the device-wide one a four-card
    cell takes of each card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    cards = [torch.device("cuda", k) for k in range(chips)]
    torch.empty(1, device=cards[0])
    assert torch.cuda.max_memory_allocated(cards[-1]) < HOLD
    assert _held_by_another_process(chips - 1, cards) >= HOLD
