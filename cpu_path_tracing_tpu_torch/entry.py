"""Entry points, the twin of the repo's ``__graft_entry__.py``.

``entry()``             — one forward render (box_mirror 256x192 at 4 spp) as
                          ``(fn, args)``, on the card unless asked otherwise.
``dryrun_multichip(n)`` — the mesh-parallel sequence on an n-entry mesh: a
                          sharded target render, one ``make_sharded_train_step``
                          step, one ``make_sharded_accum_train_step`` step and
                          the kernel route under the mesh.  The entries may
                          name one device more than once (``['cuda:0'] * 4``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import RenderConfig, get_scene
from .render import render_cells_range


def entry(device="cuda"):
    """Returns (fn, example_args): ``fn(scene, cell_ids)`` is the mean
    radiance [num_cells, 3] of every cell, through ``render_cells_range``
    (the forward kernel on the card)."""
    cfg = RenderConfig(width=256, height=192, spp=4, max_depth=100)
    scene = get_scene("box_mirror", cfg.width, cfg.height).to(device)
    cell_ids = torch.arange(cfg.num_cells, device=scene.device)

    def forward(scene, cell_ids):
        return render_cells_range(scene, cfg, cell_ids, 0, cfg.spp) / cfg.spp

    return forward, (scene, cell_ids)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """One step of each mesh-parallel inverse step on tiny shapes, as the
    JAX ``dryrun_multichip``: a 2-axis mesh (tiles x samples) when
    ``n_devices`` is even.  ``devices`` defaults to the visible cards in
    turn, repeated up to ``n_devices`` entries.  Returns the losses and the
    kernel route's mean; raises on a non-finite value."""
    from .grad import make_sharded_accum_train_step, make_sharded_train_step, split_params
    from .parallel.mesh import make_mesh
    from .parallel.render import render_cells_sharded

    if devices is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError("no CUDA device is available: pass devices= (e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    n_samples = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices // n_samples, n_samples, list(devices)[:n_devices])
    first = mesh.devices[0][0]

    cfg = RenderConfig(width=16, height=8, spp=2 * n_samples, max_depth=6, loop="scan")
    scene = get_scene("box", cfg.width, cfg.height).to(first)

    # The sharded forward render makes the target of the training step.
    target = render_cells_sharded(scene, cfg, mesh)
    n_tiles = mesh.shape["tiles"]
    pad = (-cfg.num_cells) % n_tiles
    target_padded = torch.cat([target, target.new_zeros((pad, 3))])
    cell_ids = torch.cat([torch.arange(cfg.num_cells, device=first),
                          torch.zeros(pad, dtype=torch.int64, device=first)])

    params = {k: (v + 0.01).requires_grad_(True)
              for k, v in split_params(scene, ("p0", "radius", "albedo")).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2)
    step = make_sharded_train_step(mesh, cfg, optimizer)
    params, loss = step(params, scene, cell_ids, target_padded)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss {float(loss)}")

    # The production machinery under the same mesh: the cell-chunk loop, the
    # forward kernel and the sample-chunked backward.
    step2 = make_sharded_accum_train_step(mesh, scene, cfg.replace(loop="while"), 1e-2,
                                          cell_chunk=cfg.num_cells // 2, sample_chunk=2)
    _, loss2 = step2({k: v.detach() for k, v in params.items()}, target)
    if not bool(torch.isfinite(loss2)):
        raise FloatingPointError(f"non-finite accum loss {float(loss2)}")

    # The kernel route under the mesh.
    pal_cells = render_cells_sharded(scene, cfg.replace(loop="while", integrator="pallas",
                                                        max_depth=4), mesh)
    if not bool(torch.isfinite(pal_cells).all()):
        raise FloatingPointError("non-finite cells on the kernel route")
    out = {"mesh": mesh.shape, "loss": float(loss), "accum_loss": float(loss2),
           "pallas_mesh_mean": float(pal_cells.mean())}
    print(f"dryrun_multichip({n_devices}): mesh={out['mesh']} loss={out['loss']:.6f} "
          f"accum_loss={out['accum_loss']:.6f} pallas_mesh_mean={out['pallas_mesh_mean']:.5f} ok")
    return out


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out.mean()))
