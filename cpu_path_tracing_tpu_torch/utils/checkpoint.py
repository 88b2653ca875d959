"""Progressive rendering with checkpoint and resume; inverse-run checkpoints.

Counterpart of ``cpu_path_tracing_tpu/utils/checkpoint.py``, with its
``.npz`` keys and fingerprints:

* ``render_progressive`` renders ``cfg.spp`` samples a cell in batches of
  ``flush_every`` (one ``render_cells_range`` call each, on the scene's
  device: one launch of the forward kernel on the card), adds each batch's
  per-cell sums into a host array and, with a checkpoint path, saves the
  sums and the samples done after every batch.  Each sample is keyed by its
  global index (ops/rng.py), so a resumed render equals the uninterrupted
  one bitwise; against a single pass it differs only by the association of
  the per-batch sums.
* ``InvertState`` saves an inverse run's params, Adam's state
  (``grad.make_accum_train_step``'s ``state_dict``) and the step count, so a
  resumed run continues the uninterrupted trajectory bitwise.
* Both refuse a checkpoint written for another scene or config: the
  fingerprint hashes the scene's fields in the JAX pytree's leaf order (on
  the host; never the packed kernel table) and the config fields that change
  a sample, as the JAX package does, so a checkpoint's fingerprint is the
  same in both packages.

Files are written to ``<path>.tmp.npz`` and moved into place with
``os.replace``, so a killed run leaves the last complete checkpoint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..grad import flatten_params, unflatten_params
from ..models.camera import FIELDS as CAMERA_FIELDS
from ..models.scene import SPHERE_FIELDS, Scene
from ..render import finalize_image, render_cells_range

# The leaves of the JAX ``Scene`` pytree in its order: the sphere fields,
# the camera's eight fields, the background (``ior`` is static).
_SCENE_LEAVES = SPHERE_FIELDS + tuple(f"camera.{f}" for f in CAMERA_FIELDS) + ("background",)


def _leaf(scene: Scene, name: str) -> torch.Tensor:
    obj = scene
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _fingerprint(scene: Scene, cfg: RenderConfig) -> str:
    h = hashlib.sha256()
    for name in _SCENE_LEAVES:
        h.update(np.ascontiguousarray(_leaf(scene, name).detach().cpu().numpy()).tobytes())
    # Fields that change the per-sample computation (spp excluded: resuming
    # with another total is legitimate).
    key = {f: getattr(cfg, f) for f in (
        "width", "height", "num_subpixels", "max_depth", "rr_depth", "seed", "epsilon", "inf")}
    h.update(json.dumps(key, sort_keys=True).encode())
    return h.hexdigest()[:16]


def _save_npz(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _host_dtype(scene: Scene):
    return torch.empty((), dtype=scene.dtype).numpy().dtype


def _final_image(sums: np.ndarray, spp: int, cfg: RenderConfig, device) -> torch.Tensor:
    """Cell sums on the host -> linear image, divided and finalized on
    ``device`` as ``render.render_image`` does there."""
    return finalize_image(torch.from_numpy(sums).to(device) / spp, cfg)


@dataclasses.dataclass
class ProgressiveState:
    sums: np.ndarray  # [num_cells, 3] radiance sums over the completed samples
    spp_done: int
    fingerprint: str

    def save(self, path: str) -> None:
        _save_npz(path, sums=self.sums, spp_done=self.spp_done, fingerprint=self.fingerprint)

    @staticmethod
    def load(path: str) -> "ProgressiveState":
        z = np.load(path, allow_pickle=False)
        return ProgressiveState(sums=z["sums"], spp_done=int(z["spp_done"]),
                                fingerprint=str(z["fingerprint"]))


@dataclasses.dataclass
class InvertState:
    """An inverse run's checkpoint: params, Adam's state and the step.

    ``params`` is the params dict (``grad.split_params``'s form);
    ``opt_state`` Adam's ``state_dict()`` as ``step.state_dict()["optimizer"]``
    gives it (an empty ``state`` before the first step).  The file has the
    JAX keys: ``params_leaf_NNN`` (the leaves in ``grad.flatten_params``
    order, the JAX pytree's), ``opt_leaf_000`` Adam's step counter and then
    the first and the second moments of each leaf (optax's ``count``, ``mu``
    and ``nu``), ``step`` and ``fingerprint``.  Every array keeps its dtype.
    """

    params: dict
    opt_state: dict
    step: int
    fingerprint: str

    def save(self, path: str) -> None:
        leaves = flatten_params(self.params)[1]
        payload = {f"params_leaf_{i:03d}": v.detach().cpu().numpy() for i, v in enumerate(leaves)}
        per_leaf = self.opt_state.get("state", {})
        if per_leaf:
            count = per_leaf[0]["step"]
            mu = [per_leaf[i]["exp_avg"] for i in range(len(leaves))]
            nu = [per_leaf[i]["exp_avg_sq"] for i in range(len(leaves))]
        else:  # Adam before its first step: what it would start from
            count = torch.tensor(0.0)
            mu = nu = [torch.zeros_like(v) for v in leaves]
        opt = [count, *mu, *nu]
        payload.update({f"opt_leaf_{i:03d}": v.detach().cpu().numpy() for i, v in enumerate(opt)})
        _save_npz(path, step=self.step, fingerprint=self.fingerprint, **payload)

    @staticmethod
    def load(path: str, params_template) -> "InvertState":
        """Rebuild the params in the template's structure, each leaf on its
        template's device; Adam's counter on the host, its moments on the
        leaves' devices.  Nothing is cast."""
        z = np.load(path, allow_pickle=False)
        names, t_leaves = flatten_params(params_template)
        n = len(t_leaves)

        def get(key, like):
            return torch.from_numpy(z[key]).to(like.device)

        leaves = [get(f"params_leaf_{i:03d}", t) for i, t in enumerate(t_leaves)]
        count = torch.from_numpy(z["opt_leaf_000"])
        per_leaf = {i: {"step": count.clone(),
                        "exp_avg": get(f"opt_leaf_{1 + i:03d}", t),
                        "exp_avg_sq": get(f"opt_leaf_{1 + n + i:03d}", t)}
                    for i, t in enumerate(t_leaves)}
        return InvertState(params=unflatten_params(names, leaves),
                           opt_state={"state": per_leaf},
                           step=int(z["step"]), fingerprint=str(z["fingerprint"]))


def invert_fingerprint(scene: Scene, cfg: RenderConfig, fields, lr: float, cell_chunk=None,
                       sample_chunk=None, mesh_shape=None) -> str:
    """The render fingerprint plus what shapes the optimization trajectory:
    the fields, ``lr``, spp, the chunk sizes and the mesh: another chunking,
    or the shards' sums added in another order, reorders the float sums, so
    a resume is bitwise only under the same ones, and a one-device
    checkpoint must not continue under ``--mesh``.  ``mesh_shape`` is
    (n_tiles, n_samples), or None for one device; hashed as JAX does
    (``"mesh": [t, s]`` or null), so the two fingerprints agree."""
    h = hashlib.sha256()
    h.update(_fingerprint(scene, cfg).encode())
    h.update(json.dumps({"fields": sorted(fields), "lr": lr, "spp": cfg.spp,
                         "cell_chunk": cell_chunk, "sample_chunk": sample_chunk,
                         "mesh": list(mesh_shape) if mesh_shape else None}).encode())
    return h.hexdigest()[:16]


def load_or_init_invert(path: Optional[str], fingerprint: str, params) -> InvertState:
    """Resume from ``path`` when it exists and matches, else a fresh state
    at step 0 (Adam's empty state)."""
    if path and os.path.exists(path):
        state = InvertState.load(path, params)
        if state.fingerprint != fingerprint:
            raise ValueError(
                f"invert checkpoint {path} was written for a different "
                f"scene/config/optimizer (fingerprint {state.fingerprint} != {fingerprint})")
        return state
    return InvertState(params=params, opt_state={"state": {}}, step=0, fingerprint=fingerprint)


def render_progressive(scene: Scene, cfg: RenderConfig, checkpoint_path: Optional[str] = None,
                       flush_every: int = 0, progress: Optional[Callable[[int, int], None]] = None,
                       preview_path: Optional[str] = None) -> torch.Tensor:
    """Render cfg.spp samples a cell in batches of ``flush_every`` (all of
    them at once when 0), checkpointing after each; resumes from
    ``checkpoint_path`` when it exists and matches.  Returns the linear image
    [H,W,3] on the scene's device.  ``preview_path``: the partial image is
    written there after every batch but the last, on the native writer
    thread (``utils/image.write_png_async``)."""
    from .image import flush_async_writes, write_png_async
    from .profiling import annotate

    flush_every = flush_every or cfg.spp
    fp = _fingerprint(scene, cfg)
    cell_ids = range(cfg.num_cells)

    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = ProgressiveState.load(checkpoint_path)
        if state.fingerprint != fp:
            raise ValueError(f"checkpoint {checkpoint_path} was written for a different "
                             f"scene/config (fingerprint {state.fingerprint} != {fp})")
    if state is None:
        state = ProgressiveState(sums=np.zeros((cfg.num_cells, 3), _host_dtype(scene)),
                                 spp_done=0, fingerprint=fp)

    while state.spp_done < cfg.spp:
        n = min(flush_every, cfg.spp - state.spp_done)
        with annotate("pt.progressive.batch"):
            batch = render_cells_range(scene, cfg, cell_ids, state.spp_done, n)
        with annotate("pt.progressive.flush"):
            state.sums = state.sums + batch.cpu().numpy()
            state.spp_done += n
            if checkpoint_path:
                state.save(checkpoint_path)
        if preview_path and state.spp_done < cfg.spp:
            with annotate("pt.progressive.encode"):
                partial = _final_image(state.sums, state.spp_done, cfg, scene.device)
                write_png_async(preview_path, partial.cpu().numpy().astype(np.float32))
        if progress:
            progress(state.spp_done, cfg.spp)

    if preview_path:
        flush_async_writes()
    return _final_image(state.sums, cfg.spp, cfg, scene.device)
