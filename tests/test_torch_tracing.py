"""The port's spans (``utils/profiling.annotate``) on the step and image paths.

Under a CPU-only ``torch.profiler`` the step of ``make_accum_train_step``,
``render_image``, the kernel wrappers and the progressive render record
their ``pt.*`` spans in the tree the benchmark's readers take apart
(``port_bench/harness/spans.py``); with no profiler recording, no span is
entered at all.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.ops.kernels.geometry_replay import geometry_param_grads_kernel
from cpu_path_tracing_tpu_torch.ops.kernels.replay import replay_param_grads_kernel
from cpu_path_tracing_tpu_torch.ops.wavefront import render_wavefront_persistent
from cpu_path_tracing_tpu_torch.render import render_image
from cpu_path_tracing_tpu_torch.utils import profiling
from cpu_path_tracing_tpu_torch.utils.checkpoint import render_progressive

CFG = tp.RenderConfig(width=8, height=6, spp=2, max_depth=4)  # 192 cells


def _box():
    return tp.get_scene("box", CFG.width, CFG.height)


def _spans(prof):
    """(start ns, end ns, name) of every ``pt.*`` span of a finished profile."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("pt."))


def _children(spans, parent):
    """The names of the spans directly inside ``parent``, in order."""
    inside = [sp for sp in spans
              if sp is not parent and parent[0] <= sp[0] and sp[1] <= parent[1]]
    return [sp[2] for sp in inside
            if not any(o is not sp and o[0] <= sp[0] and sp[1] <= o[1] for o in inside)]


def _only(spans, name):
    found = [sp for sp in spans if sp[2] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def _step_and_target():
    scene = _box()
    target = grad.render_target(scene, CFG)
    params = {k: v + 0.03 for k, v in grad.split_params(scene, ("albedo", "emission")).items()}
    return grad.make_accum_train_step(scene, CFG, 1e-2, cell_chunk=96), params, target


def test_a_step_records_its_chunk_loop():
    step, params, target = _step_and_target()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, target)
    spans = _spans(prof)
    chunk = ["pt.grad.forward", "pt.grad.cotangent", "pt.grad.backward"]
    assert _children(spans, _only(spans, "pt.step")) == [
        "pt.adam", "pt.grad.start", *chunk, *chunk, "pt.grad.accumulate", "pt.adam"]
    forwards = [sp for sp in spans if sp[2] == "pt.grad.forward"]
    assert [_children(spans, f) for f in forwards] == [["pt.k2"], ["pt.k2"]]


def test_an_image_records_setup_launch_and_finalize():
    cfg = CFG.replace(ray_chunk=96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_image(_box(), cfg)
    spans = _spans(prof)
    assert _children(spans, _only(spans, "pt.render_image")) == [
        "pt.render.setup", "pt.k2", "pt.render.setup", "pt.k2", "pt.render.finalize"]


def _k2(scene, ids, ct):
    return render_wavefront_persistent(scene, CFG, ids, 0, CFG.spp)


def _k3(scene, ids, ct):
    return replay_param_grads_kernel(scene, CFG, ids, 0, CFG.spp, ct)


def _k7(scene, ids, ct):
    return geometry_param_grads_kernel(scene, CFG, ids, 0, CFG.spp, ct)


@pytest.mark.parametrize("wrapper, name, inner", [(_k2, "pt.k2", []), (_k3, "pt.k3", []),
                                                  (_k7, "pt.k7", ["pt.k7.map"])])
def test_each_kernel_wrapper_records_its_span(wrapper, name, inner):
    """On CPU tensors the wrappers run their plain versions, inside the
    same spans as the launches on the card.  The cells go as the port's
    callers pass them, a host range: nothing is read back."""
    scene = _box()
    ct = torch.full((32, 3), 0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wrapper(scene, range(32, 64), ct)
    spans = _spans(prof)
    assert _children(spans, _only(spans, name)) == inner
    assert {sp[2] for sp in spans} == {name, *inner}


@pytest.mark.parametrize("wrapper, name", [(_k2, "pt.k2"), (_k3, "pt.k3"), (_k7, "pt.k7")])
def test_a_wrapper_reads_an_id_tensor_back_under_its_own_span(wrapper, name):
    """An id tensor, as a public caller may pass, is checked and read back
    inside ``pt.cells.readback``, the wrapper's first child: a trace names
    whoever still pays for it."""
    scene = _box()
    ct = torch.full((32, 3), 0.1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wrapper(scene, torch.arange(32, 64), ct)
    spans = _spans(prof)
    assert _children(spans, _only(spans, name))[0] == "pt.cells.readback"
    assert [sp[2] for sp in spans].count("pt.cells.readback") == 1


def test_a_progressive_render_records_batch_flush_and_encode(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_progressive(_box(), CFG, flush_every=1, preview_path=str(tmp_path / "p.png"))
    names = [sp[2] for sp in _spans(prof)]
    assert names.count("pt.progressive.batch") == 2 and names.count("pt.progressive.flush") == 2
    assert names.count("pt.progressive.encode") == 1


def _no_span(*args, **kwargs):
    raise AssertionError("a span was entered with no profiler recording")


@pytest.mark.parametrize("path", ["step", "image"])
def test_with_no_profiler_no_span_is_entered(monkeypatch, path):
    monkeypatch.setattr(torch.profiler, "record_function", _no_span)
    if path == "step":
        step, params, target = _step_and_target()
        step(params, target)
    else:
        render_image(_box(), CFG.replace(ray_chunk=96))


def test_annotate_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = profiling.annotate("pt.a")
    assert profiling.annotate("pt.b") is off
    with off as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.annotate("pt.a") is not off
