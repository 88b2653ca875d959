"""BENCHMARK.json against the form it must have, and the files it names;
and a four-card cell added as new files and entries alone."""

import io
import json
import re
import shutil

import pytest
import torch

from harness import runner
from harness.spec import BENCH_DIR, ROOT, Cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def check_top_level_keys_and_command(spec, root):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "port_bench/run.py"]
    assert spec["paths"] == ["port_bench"] and 1 <= spec["run_seconds"] <= 51
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def check_names_units_and_keys(spec):
    metrics = spec["end_to_end"] + spec["per_layer"]
    cells = [w["name"] for w in spec["workloads"]]
    names = [m["name"] for m in metrics] + cells + [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and len(m["layer"]) <= 200
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert len(c["why"]) <= 200 and c["reduced"] == []
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


def check_cards(workloads):
    """A cell takes 1 card or 4, and at most a quarter of the cells,
    rounded down, take 4; one always may."""
    chips = [w["chips"] for w in workloads]
    assert all(c in (1, 4) for c in chips), chips
    assert chips.count(4) <= max(1, len(chips) // 4), chips


def check_every_cell_reports_what_its_metrics_move(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    for cell in cells:
        reported = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m.get("workloads", [cell]) for m in spec["per_layer"]), cell
    for m in spec["per_layer"]:
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def check_metrics_of_one_layer_share_its_name(spec):
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def check_cell_finds_its_files(cell):
    assert cell.loop().Cell.unit in ("image", "step")
    for m in cell.end_to_end() + cell.per_layer():
        assert callable(cell.reader(m)), m["name"]
    assert set(cell.traffic["limits"]) and all(v > 0 for v in cell.traffic["limits"].values())


def check_config_files_hold_what_is_run(spec, root, bench_dir):
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (root / c["file"]).resolve().is_relative_to(bench_dir.resolve())


def check_all(spec, root, bench_dir):
    check_top_level_keys_and_command(spec, root)
    check_names_units_and_keys(spec)
    check_cards(spec["workloads"])
    check_every_cell_reports_what_its_metrics_move(spec)
    check_metrics_of_one_layer_share_its_name(spec)
    for w in spec["workloads"]:
        check_cell_finds_its_files(Cell(w["name"], root=root, bench_dir=bench_dir))
    check_config_files_hold_what_is_run(spec, root, bench_dir)


def test_top_level_keys_and_command():
    check_top_level_keys_and_command(SPEC, ROOT)


def test_names_units_and_keys():
    check_names_units_and_keys(SPEC)


def _cells(*chips):
    return [{"name": f"c{i}", "chips": c} for i, c in enumerate(chips)]


@pytest.mark.parametrize("workloads, ok", [
    (SPEC["workloads"], True),
    (_cells(1, 1, 1, 1, 4), True),
    (_cells(4), True),
    (_cells(1, 1, 1, 4, 4), False),
    (_cells(1, 1, 1, 1, 2), False),
], ids=["this benchmark", "four one-card and one four-card", "a lone four-card cell",
        "two four-card among five", "two cards"])
def test_the_card_rule(workloads, ok):
    if ok:
        check_cards(workloads)
    else:
        with pytest.raises(AssertionError):
            check_cards(workloads)


def test_every_cell_reports_what_its_metrics_move():
    check_every_cell_reports_what_its_metrics_move(SPEC)


def test_metrics_of_one_layer_share_its_name():
    check_metrics_of_one_layer_share_its_name(SPEC)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    check_cell_finds_its_files(Cell(cell))


def test_config_files_hold_what_is_run():
    check_config_files_hold_what_is_run(SPEC, ROOT, BENCH_DIR)


STUB_LOOP = '''"""A stand-in loop that keeps the cards the runner hands it."""


class Cell:
    unit = "step"
    min_units = 0

    def __init__(self, config, traffic, seed, device, program=None):
        self.limit, self.profiled = traffic["limits"]["cards"], [1]

    def setup(self):
        self.seen = list(self.cards)

    def prepare(self, i):
        pass

    def run(self, i):
        return i

    def settle(self, i, out):
        return True

    def release(self):
        self.notes = ["cards handed to the loop: " + " ".join(map(str, self.seen))]

    def check(self):
        return [("cards", len(self.seen), self.limit)]

    def counts(self):
        return {}
'''


def _add_four_card_cell(root):
    """Add a four-card cell to the copy at ``root`` as new files and new
    entries of BENCHMARK.json, the way a configuration is added."""
    bench = root / "port_bench"
    cfg = {"name": "stub_2x2", "source": "https://github.com/AlexandruIca/cpu-path-tracing",
           "reduced": []}
    (bench / "configs" / "stub_2x2.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "stub_cards.json").write_text(
        json.dumps({"loop": "stub_cards_loop", "limits": {"cards": 4}}))
    (bench / "loops" / "stub_cards_loop.py").write_text(STUB_LOOP)
    (bench / "metrics" / "cards_seen.py").write_text("def read(ctx):\n    return None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(cfg, file="port_bench/configs/stub_2x2.json",
                                why="a stand-in"))
    spec["workloads"].append({"name": "stub_2x2.cards", "config": "stub_2x2",
                              "traffic": "stub_cards", "chips": 4, "why": "a stand-in"})
    for m in spec["end_to_end"]:
        if m["name"] in ("step_ms", "step_ms_p95"):
            m["workloads"].append("stub_2x2.cards")
    spec["per_layer"].append({"name": "cards_seen", "unit": "cards", "better": "higher",
                              "source": "program_counter", "layer": "parallel cards",
                              "moves": "step_ms", "workloads": ["stub_2x2.cards"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return spec


def test_a_four_card_cell_is_new_files_and_entries_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    spec = _add_four_card_cell(tmp_path)
    bench = tmp_path / "port_bench"
    for f in BENCH_DIR.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (bench / f.relative_to(BENCH_DIR)).read_bytes() == f.read_bytes(), f
    check_all(spec, tmp_path, bench)

    cell = Cell("stub_2x2.cards", root=tmp_path, bench_dir=bench)
    assert cell.chips == 4
    out, err = io.StringIO(), io.StringIO()
    assert runner.run(cell, 2**40 + 1, 0.01, False, torch.device("cpu"), 0.0, out=out,
                      err=err) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] and result["device"]["count"] == 4
    assert {"step_ms", "step_ms_p95", "setup_s"} == set(result["metrics"])
    assert "cards handed to the loop: cpu:0 cpu:1 cpu:2 cpu:3" in err.getvalue()
