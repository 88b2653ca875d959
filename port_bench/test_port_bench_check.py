"""``correct`` at tiny sizes: the port's runs come out correct; the control
(the reference in bfloat16 in the port's place) and every fault planted
under the timed path come out not correct.  The same runs on the card,
where there is one, in the ``cuda`` tests."""

import io
import json

import pytest
import torch

import control
from harness import runner
from harness.spec import Cell
from harness.stats import derive

SEED = 2**32 + 17


def _tiny(name):
    cell = Cell(name)
    if cell.traffic["loop"] == "image_loop":
        cell.config.update(width=24, height=16)
        cell.traffic.update(check_from=4, profile_from=1, profiled=2)
    else:
        cell.config.update(width=12, height=12, spp=1, cell_chunk=200)
        cell.traffic.update(fit_steps=3, checked_steps=2, profiled=1)
        if "own_norm" in cell.traffic:
            # The box's p0 and radius gradients come from the rare paths that
            # escape it; none does at this size, so the ceiling is taken off.
            spheres = cell.config["scene"]["spheres"]
            spheres.remove(max(spheres, key=lambda s: s[2]))
    return cell


def _result(name, mode, device, traced=False, cell=None, program=None, err=None):
    cell = cell or _tiny(name)
    out = io.StringIO()
    prog = program or control.program_for(mode, cell, device, SEED)
    assert runner.run(cell, SEED, 0.05, traced, device, 0.0, program=prog, out=out, err=err) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


IMAGE_MODES = ["control", "stale", "half", "altered"]
FIT_MODES = ["control", "half", "altered", "unchanged"]
FIT_CELL_MODES = {"box_400x400.invert": FIT_MODES,
                  "box_400x400.geometry": FIT_MODES + ["altered_geometry"]}


@pytest.mark.parametrize("name", ["disco_1024x768.render", "disco_1024x768.preview",
                                  "box_400x400.invert", "box_400x400.geometry"])
def test_the_ports_run_is_correct(name):
    r = _result(name, "sound", torch.device("cpu"))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]


@pytest.mark.parametrize("mode", IMAGE_MODES)
@pytest.mark.parametrize("name", ["disco_1024x768.render", "disco_1024x768.preview"])
def test_an_image_fault_or_the_control_is_not_correct(name, mode):
    assert not _result(name, mode, torch.device("cpu"))["correct"]


@pytest.mark.parametrize("name, mode", [(n, m) for n, modes in FIT_CELL_MODES.items()
                                        for m in modes])
def test_a_step_fault_or_the_control_is_not_correct(name, mode):
    assert not _result(name, mode, torch.device("cpu"))["correct"]


def test_the_geometry_leaves_are_held_to_their_own_norm():
    cell = _tiny("box_400x400.geometry")
    sound = _result(cell.name, "sound", torch.device("cpu"), cell=cell)["checks"]
    faulty = _result(cell.name, "altered_geometry", torch.device("cpu"), cell=cell)["checks"]
    assert sound["own_grad_gap"]["value"] <= 1e-5
    # p0 and radius 1.5 times the port's: only their own norm sees it.
    assert faulty["own_grad_gap"]["value"] == pytest.approx(0.5, rel=1e-5)
    assert faulty["grad_gap"]["value"] <= faulty["grad_gap"]["limit"]


def _with_a_window_fit(name):
    """The tiny cell, its window run on until a fit that starts inside it
    has taken the steps the check compares."""
    cell = _tiny(name)
    t = cell.traffic
    units = t["fit_steps"] - t["checked_steps"] + t["compared_steps"]
    load = cell.loop

    def loop():
        mod = load()
        mod.Cell.min_units = units
        return mod

    cell.loop = loop
    return cell


@pytest.mark.parametrize("name", ["box_400x400.invert", "box_400x400.geometry"])
def test_the_check_follows_a_fit_that_started_in_the_window(name):
    device = torch.device("cpu")
    err = io.StringIO()
    assert _result(name, "sound", device, cell=_with_a_window_fit(name), err=err)["correct"]
    assert "compared fit 1 " in err.getvalue()
    # A reset at a fit's start that leaves Adam's moments as they were: the
    # set-up's fit is sound, the window's next one is not.
    cell = _with_a_window_fit(name)
    prog = cell.loop().Port(cell.config, device, derive(SEED, 1))
    make = prog.make_step

    def sticky():
        step = make()
        step.load_state_dict = lambda sd: None
        return step

    prog.make_step = sticky
    assert not _result(name, "sound", device, cell=cell, program=prog)["correct"]


def test_a_traced_run_reads_its_metrics():
    r = _result("disco_1024x768.preview", "sound", torch.device("cpu"), traced=True)
    assert r["correct"] and {"device_idle_pct.image", "device_ops_per_image"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, modes", [("disco_1024x768.preview", IMAGE_MODES),
                                         *FIT_CELL_MODES.items()])
def test_on_the_card_the_port_is_correct_and_the_rest_is_not(cuda, name, modes):
    assert _result(name, "sound", cuda)["correct"]
    for mode in modes:
        assert not _result(name, mode, cuda)["correct"], mode
