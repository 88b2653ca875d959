"""A launch's cell span as host integers (``ops/kernels/megakernel.cell_span``).

The port's callers pass a contiguous span as a host ``range``, which the
kernel wrappers read with no torch call, so nothing inside a step or an
image waits on the card for a number the host already had.  An id tensor,
as a public caller may pass, is still checked and read back.  Either form
gives the kernels the same ``(cell_start, sample_start)``, ``n_cells`` and
``n_items``, so every output is bitwise the same.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import cpu_path_tracing_tpu_torch as tp
from cpu_path_tracing_tpu_torch import grad
from cpu_path_tracing_tpu_torch.ops.kernels.geometry_replay import geometry_param_grads_kernel
from cpu_path_tracing_tpu_torch.ops.kernels.megakernel import cell_ids_of, cell_span
from cpu_path_tracing_tpu_torch.ops.kernels.replay import replay_param_grads_kernel
from cpu_path_tracing_tpu_torch.render import render_cells_range, render_image

CFG = tp.RenderConfig(width=8, height=6, spp=2, max_depth=8)  # 192 cells
READ_BACK = "aten::_local_scalar_dense"  # behind int(t), bool(t) and t.item()


class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _box():
    return tp.get_scene("box", CFG.width, CFG.height)


@pytest.mark.parametrize("cells, want", [(range(3, 10), (3, 7)), (range(5, 6), (5, 1)),
                                         (range(0), (0, 0)), (range(7, 7), (0, 0)),
                                         (range(2 ** 40, 2 ** 40 + 4), (2 ** 40, 4))])
def test_a_host_span_is_read_without_any_torch_op(cells, want):
    with _Ops() as ops:
        got = cell_span(cells)
    assert got == want and ops.names == []


def test_an_id_tensor_is_still_read_back():
    """The same span as a tensor: the same answer, by a read-back, which
    the recording mode sees (so it would see one on the host path)."""
    with _Ops() as ops:
        got = cell_span(torch.arange(3, 10))
    assert got == (3, 7) and READ_BACK in ops.names
    assert cell_span(torch.arange(0)) == (0, 0)


def test_a_host_span_becomes_ids_without_a_read_back():
    with _Ops() as ops:
        ids = cell_ids_of(range(3, 10), torch.device("cpu"))
    assert READ_BACK not in ops.names
    assert ids.dtype == torch.int64 and torch.equal(ids, torch.arange(3, 10))
    t = torch.tensor([4, 1, 9])
    assert cell_ids_of(t, torch.device("cpu")) is t


def _render(scene, ids):
    return render_cells_range(scene, CFG, ids, 1, 1)


def _k3(scene, ids):
    return replay_param_grads_kernel(scene, CFG, ids, 1, 1, torch.full((len(ids), 3), 0.1))


def _k7(scene, ids):
    return geometry_param_grads_kernel(scene, CFG, ids, 1, 1, torch.full((len(ids), 3), 0.1))


@pytest.mark.parametrize("entry", [_render, _k3, _k7])
@pytest.mark.parametrize("ids", [torch.tensor([0, 2, 4, 6]), torch.tensor([5, 4, 3]),
                                 range(0, 8, 2)], ids=["gaps", "descending", "range_step_2"])
def test_a_span_that_is_not_contiguous_raises(entry, ids):
    """On the plain route and from the replay and geometry replay wrappers:
    the check that a tensor meets is not loosened, and a range is held to
    the same rule."""
    with pytest.raises(ValueError, match="contiguous"):
        entry(_box(), ids)


@pytest.mark.parametrize("route", ["plain", "wavefront", "per_step", "batch"])
def test_a_range_renders_bitwise_as_its_id_tensor(route):
    cfg = {"plain": CFG, "wavefront": CFG.replace(integrator="wavefront"),
           "per_step": CFG.replace(integrator="pallas", pallas_persistent=False),
           "batch": CFG.replace(integrator="batch")}[route]
    scene = _box()
    got = render_cells_range(scene, cfg, range(40, 100), 0, 2)
    want = render_cells_range(scene, cfg, torch.arange(40, 100), 0, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wrapper", [replay_param_grads_kernel, geometry_param_grads_kernel])
def test_a_range_gives_the_wrappers_gradients_bitwise(wrapper):
    scene = _box()
    ct = torch.linspace(-0.2, 0.3, 60 * 3).reshape(60, 3)
    got = wrapper(scene, CFG, range(40, 100), 1, 2, ct)
    want = wrapper(scene, CFG, torch.arange(40, 100), 1, 2, ct)
    got, want = (dict(zip(*grad.flatten_params(g))) for g in (got, want))
    assert got.keys() == want.keys()
    for name in got:
        assert torch.equal(got[name], want[name]), name


def _tensor_shard_forward(span, names, leaves, start, per, sample_start):
    """``grad.shard_forward`` with the cells as a device id tensor, the
    form a public caller may pass."""
    return span(grad.unflatten_params(names, leaves),
                torch.arange(start, start + per, device=leaves[0].device), sample_start)


@pytest.mark.parametrize("fields, route", [(("albedo", "emission"), None),
                                           (("p0", "radius"), None),
                                           (("p0", "radius", "albedo", "emission"), "geometry")])
def test_a_step_is_bitwise_whichever_form_the_span_takes(monkeypatch, fields, route):
    """One ``make_accum_train_step`` step on a box on the CPU (the plain
    replay, the scan VJP, and the geometry route's wrappers on their plain
    versions): the same loss, first gradient and params with the cells as
    a range (the chunk loop's) or as an id tensor."""
    if route is not None:
        monkeypatch.setattr(grad, "backward_route", lambda *a, **k: route)
    scene = _box()
    target = grad.render_target(scene, CFG) * 0.9
    start = {k: v + 0.01 for k, v in grad.split_params(scene, fields).items()}

    def one_step():
        step = grad.make_accum_train_step(scene, CFG, 1e-2, cell_chunk=96)
        params, loss = step(start, target)
        moments = [s["exp_avg"] for s in step.state_dict()["optimizer"]["state"].values()]
        return loss, grad.flatten_params(params)[1], moments

    got = one_step()
    monkeypatch.setattr(grad, "shard_forward", _tensor_shard_forward)
    want = one_step()
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1] + tuple(got[2]), want[1] + tuple(want[2])):
        assert torch.equal(a, b)


def _names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("path", ["step", "image"])
def test_no_read_back_span_on_the_step_or_image_path(monkeypatch, path):
    """The chunk loop, ``render_target`` and ``render_image`` hand every
    wrapper a host span: a traced step on the geometry route (K2, K7 and K3's
    wrappers on their plain versions) and a traced image hold no
    ``pt.cells.readback``."""
    scene = _box()
    if path == "step":
        monkeypatch.setattr(grad, "backward_route", lambda *a, **k: "geometry")
        step = grad.make_accum_train_step(scene, CFG, 1e-2, cell_chunk=96)
        params = {k: v + 0.01 for k, v in grad.split_params(scene, ("p0", "albedo")).items()}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(params, grad.render_target(scene, CFG))
        want = {"pt.k2", "pt.k3", "pt.k7"}
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            render_image(scene, CFG.replace(ray_chunk=96))
        want = {"pt.k2"}
    names = _names(prof)
    assert want <= set(names) and "pt.cells.readback" not in names
