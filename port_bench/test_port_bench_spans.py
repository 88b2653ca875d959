"""The readers of the port's spans (``harness/spans.py``): on hand-built
traces, in tiny traced runs on the CPU, and, in the ``cuda`` test, the
spans of a geometry step on the card against its kernels' device rows."""

import io
import json
import re
from types import SimpleNamespace

import pytest
import torch

from harness import runner, shares, spans
from harness.spec import Cell
from harness.trace import Trace

NEW = {"step": ["host_syncs_per_step", "wrapper_idle_ms_per_step", "loop_idle_ms_per_step"],
       "image": ["host_syncs_per_image", "wrapper_idle_ms_per_image",
                 "render_idle_ms_per_image"]}


def _ctx(trace, unit="step", n=1):
    return SimpleNamespace(unit=unit, trace=trace, n_profiled=n)


def _two_threads():
    """A step 0-100 ns: the main thread's backward 5-70 waits while the
    device thread runs K3's wrapper 20-40 and K7's map 35-50 (on two
    threads, so neither holds the other); the card is busy 0-10 and
    60-100."""
    host = [("pb.step", 0, 100), ("pt.step", 0, 100), ("pt.grad.backward", 5, 70),
            ("pt.k3", 20, 40), ("pt.k7.map", 35, 50)]
    return Trace(window=(0, 100), device=[("k", 0, 10), ("k", 60, 100)], host=host)


def test_idle_goes_to_the_innermost_span_on_any_thread():
    assert spans.idle_by_span(_two_threads()) == {"pt.grad.backward": 20, "pt.k3": 15,
                                                  "pt.k7.map": 15}


def test_the_three_parts_add_up_to_the_idle_time():
    """Two steps, times in ms: what no ``pt.*`` span holds (before a step's
    span, between the steps, after) is the harness's."""
    ms = 1_000_000
    host = [("pb.step", 0, 90), ("pt.step", 5, 80), ("pt.adam", 70, 78), ("pt.k2", 10, 30),
            ("pb.step", 100, 190), ("pt.step", 105, 180), ("pt.k2", 110, 130)]
    device = [("k", 12, 28), ("k", 40, 50), ("k", 112, 129), ("k", 150, 170), ("k", 185, 200)]
    trace = Trace(window=(0, 200 * ms), device=[(n, s * ms, e * ms) for n, s, e in device],
                  host=[(n, s * ms, e * ms) for n, s, e in host])
    by = {n: v / ms for n, v in spans.idle_by_span(trace).items()}
    idle = 200 - (16 + 10 + 17 + 20 + 15)
    assert sum(by.values()) == idle
    assert by == {"pt.k2": 2 + 2 + 2 + 1, "pt.step": 5 + 10 + 20 + 2 + 5 + 20 + 10,
                  "pt.adam": 8, None: 5 + 25 + 5}
    ctx = _ctx(trace, n=2)
    wrapper = spans.idle_ms_per_unit(ctx, "step", "wrapper")
    loop = spans.idle_ms_per_unit(ctx, "step", "program")
    assert wrapper["value"] == pytest.approx(7 / 2)
    assert loop["value"] == pytest.approx((72 + 8) / 2)
    assert wrapper["value"] + loop["value"] + 35 / 2 == pytest.approx(idle / 2)
    assert loop["note"].startswith("pt.step 36.0000, pt.adam 4.0000 ms a step")
    assert wrapper["note"] == ("pt.k2 3.5000 ms a step; idle ms a step: wrappers 3.5000 + "
                               "program 40.0000 + harness 17.5000 = 61.0000 of 61.0000 in the "
                               "window")


def test_a_sync_outside_the_programs_spans_is_not_counted():
    host = [("pb.step", 0, 200), ("pt.step", 0, 100), ("pt.k2", 10, 40),
            ("cudaStreamSynchronize", 20, 21), ("cudaMemcpyAsync", 19, 20),
            ("cudaLaunchKernel", 22, 23), ("cudaDeviceSynchronize", 60, 61),
            ("cudaStreamSynchronize", 150, 151), ("cudaDeviceSynchronize", 199, 200)]
    got = spans.syncs_per_unit(_ctx(Trace(window=(0, 200), host=host)), "step")
    assert got["value"] == 2
    assert "pt.k2 1, pt.step 1" in got["note"]


@pytest.mark.parametrize("name", ["cudaStreamSynchronize", "cudaDeviceSynchronize",
                                  "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
                                  "cuCtxSynchronize", "cuMemcpyDtoH_v2"])
def test_each_blocking_call_counts(name):
    host = [("pt.render_image", 0, 10), (name, 5, 6)]
    got = spans.syncs_per_unit(_ctx(Trace(window=(0, 10), host=host), "image"), "image")
    assert got["value"] == 1


@pytest.mark.parametrize("name", ["cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamWaitEvent",
                                  "cudaEventRecord", "cuMemcpyDtoDAsync_v2"])
def test_what_does_not_block_is_not_counted(name):
    host = [("pt.render_image", 0, 10), (name, 5, 6)]
    got = spans.syncs_per_unit(_ctx(Trace(window=(0, 10), host=host), "image"), "image")
    assert got["value"] == 0


def test_a_cell_without_the_spans_reads_none():
    """The parent's program has no ``pt.*`` span: every reader reads None,
    as it does for the other unit's cell and for a step with no wrapper."""
    bare = Trace(window=(0, 100), device=[("k", 0, 10)],
                 host=[("pb.step", 0, 100), ("aten::mul", 20, 30),
                       ("cudaStreamSynchronize", 40, 41)])
    assert spans.syncs_per_unit(_ctx(bare), "step") is None
    for part in ("wrapper", "program"):
        assert spans.idle_ms_per_unit(_ctx(bare), "step", part) is None
    assert spans.syncs_per_unit(_ctx(_two_threads()), "image") is None
    assert spans.syncs_per_unit(_ctx(None), "step") is None
    no_wrapper = Trace(window=(0, 10), host=[("pt.step", 0, 10), ("pt.adam", 2, 4)])
    assert spans.idle_ms_per_unit(_ctx(no_wrapper), "step", "wrapper") is None
    assert spans.idle_ms_per_unit(_ctx(no_wrapper), "step", "program")["value"] > 0


@pytest.mark.parametrize("name", ["box_400x400.invert", "disco_1024x768.preview"])
def test_a_tiny_traced_run_on_the_cpu_reads_the_new_metrics(name):
    cell = Cell(name)
    if cell.traffic["loop"] == "image_loop":
        cell.config.update(width=24, height=16)
        cell.traffic.update(check_from=4, profile_from=1, profiled=2)
    else:
        cell.config.update(width=12, height=12, spp=1, cell_chunk=200)
        cell.traffic.update(fit_steps=3, checked_steps=2, profiled=1)
    out, err = io.StringIO(), io.StringIO()
    assert runner.run(cell, 2**32 + 5, 0.05, True, torch.device("cpu"), 0.0, out=out,
                      err=err) == 0
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]
    names = NEW[cell.loop().Cell.unit]
    assert set(names) <= set(metrics)
    assert metrics[names[0]]["value"] == 0  # no CUDA runtime on the CPU
    notes = [ln for ln in err.getvalue().splitlines() if ln.startswith(names[1])]
    parts = re.search(r"= ([0-9.]+) of ([0-9.]+) in the window", notes[0])
    assert float(parts[1]) == pytest.approx(float(parts[2]), rel=1e-2, abs=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_the_card_a_geometry_steps_spans_lead_their_kernels(cuda):
    """The backward's wrapper spans are recorded on autograd's device
    thread, and the k-th K2, K3 and K7 row of a step starts no earlier than
    the k-th span of its wrapper: the spans and the rows share one clock."""
    from torch.profiler import ProfilerActivity, profile

    from cpu_path_tracing_tpu_torch import grad
    from loops import fit_loop

    cell = Cell("box_400x400.geometry")
    prog = fit_loop.Port(cell.config, cuda, 7)
    target, step = prog.target(), prog.make_step()
    truth = grad.split_params(prog.scene, tuple(cell.traffic["fields"]))
    params = {k: v + cell.traffic["offset"] for k, v in truth.items()}
    params, loss = step(params, target)
    float(loss)
    torch.cuda.synchronize(cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, loss = step(params, target)
        float(loss)
        torch.cuda.synchronize(cuda)
    host, device = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name().startswith("pt."):
                host.setdefault(e.name(), []).append((e.start_ns(), e.start_thread_id()))
        else:
            for k, rx in shares.KERNELS.items():
                if re.search(rx, e.name()):
                    device.setdefault(f"pt.{k}", []).append(e.start_ns())
    (_, main), = host["pt.step"]
    for name in ("pt.k3", "pt.k7"):
        assert host[name] and all(tid != main for _, tid in host[name]), name
    for name in ("pt.k2", "pt.k3", "pt.k7"):
        starts = sorted(s for s, _ in host[name])
        rows = sorted(device[name])
        assert len(starts) == len(rows) == 5, name
        assert all(r >= s for s, r in zip(starts, rows)), (name, [r - s for s, r in
                                                                  zip(starts, rows)])

