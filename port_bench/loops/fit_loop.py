"""Fits of a few Adam steps each, one client: each step's loss is waited
for before the next step is asked for (a closed loop), as ``cli invert``
does.

The configuration gives the render (``spp`` a subpixel cell), the chunks
(``cell_chunk``, ``sample_chunk``) and Adam's ``lr``.  The traffic file
gives the optimized ``fields``, how far from the true parameters a fit
starts (``offset``, plus a uniform ``jitter`` an element drawn from the
seed and the fit's index, so that no fit repeats another and every fit
does about the same work), the steps a fit takes (``fit_steps``: a fixed
count, so a faster program does not walk on into steps of another cost),
the steps set-up drives (``checked_steps``), the steps of a fit the check
follows (``compared_steps``), the leaves whose first gradient is also held
to their own norm (``own_norm``, optional: leaves whose gradient is small
beside the median leaf's, which the median would hide), the profiled
steps of a traced run (``profiled``, in the second fit, after its first
step) and the limits of the numbers compared.

Set-up builds the step, renders the target and drives the first fit's
first ``checked_steps`` steps through the step's own call, which warms it
up; the window goes on from there with the same step.  At each later
fit's start, Adam's moments and counter are reset by
``step.load_state_dict``.  Of every fit the loop keeps the losses of its
first ``compared_steps`` steps, its first gradient as Adam holds it and
its parameters after them; the check follows the last fit that got that
far, in a full window one that started inside it.
"""

from __future__ import annotations

import statistics

import torch

from harness import port
from harness.stats import derive
from plainref import fit as ref_fit
from plainref import render as ref_render
from plainref.scene import build_scene, with_params

SEED_RENDER, SEED_FIT = 1, 2
GRAD_BLOCK_RAYS = 1 << 21  # the reference's autograd batch, in items
FORWARD_BLOCK_RAYS = 1 << 23
BETA1 = 0.9


class Port:
    """The system under test: ``grad.make_accum_train_step`` of the port."""

    def __init__(self, config: dict, device, render_seed: int):
        self.config = config
        self.scene = port.scene(config, device)
        self.cfg = port.render_config(config, config["spp"], render_seed)

    def target(self):
        from cpu_path_tracing_tpu_torch import grad

        return grad.render_target(self.scene, self.cfg, self.config["cell_chunk"])

    def make_step(self):
        from cpu_path_tracing_tpu_torch import grad

        return grad.make_accum_train_step(self.scene, self.cfg, self.config["lr"],
                                          cell_chunk=self.config["cell_chunk"],
                                          sample_chunk=self.config["sample_chunk"])


def first_gradient(step) -> dict:
    """The first step's gradient as Adam holds it after one step:
    ``exp_avg = (1 - beta1) * g``."""
    sd = step.state_dict()["optimizer"]["state"]
    return {n: sd[i]["exp_avg"].float() / (1 - BETA1) for i, n in enumerate(step.leaf_names())}


def own_norm_gap(got: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the two norms, over the reference's norm
    of that leaf."""
    worst = 0.0
    for n in names:
        a, b = float(got[n].float().norm()), float(ref[n].float().norm())
        gap = abs(a - b) / b if b > 0 else (0.0 if a == 0 else float("inf"))
        worst = gap if not gap <= worst else worst
    return worst


def norm_gap(got: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {n: float(ref[n].float().norm()) for n in names}
    median = statistics.median(norms.values())
    worst = 0.0
    for n in names:
        gap = abs(float(got[n].float().norm()) - norms[n]) / max(norms[n], median)
        worst = gap if not gap <= worst else worst
    return worst


class Cell:
    unit = "step"
    min_units = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device, program=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.fields = tuple(sorted(traffic["fields"]))
        self.render_seed = derive(seed, SEED_RENDER)
        self.program = program
        self.checked = traffic["checked_steps"]
        first = traffic["fit_steps"] + 1 - self.checked
        self.profiled = list(range(first, first + traffic["profiled"]))
        self.profiled_params = {}
        self.n_cells = config["width"] * config["height"] * config["num_subpixels"] ** 2
        self.truth = build_scene(config, device)

    def start(self, fit: int) -> dict:
        """The fit's start: the true parameters + offset + jitter, made on
        the device from the seed."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(self.seed, SEED_FIT, fit))
        out = {}
        for name in self.fields:
            v = getattr(self.truth, name)
            u = torch.rand(v.shape, generator=gen, device=self.device, dtype=v.dtype)
            out[name] = v + self.traffic["offset"] + (2.0 * u - 1.0) * self.traffic["jitter"]
        return out

    def setup(self) -> None:
        self.program = self.program or Port(self.config, self.device, self.render_seed)
        self.target = self.program.target()
        self.step = self.program.make_step()
        self.fits, self.compared_fit = {}, None
        self.params = self.start(0)
        for n in range(self.checked):
            self.params, loss = self.step(self.params, self.target)
            self.keep(n, self.params, float(loss))

    def keep(self, n: int, params: dict, loss: float) -> None:
        """Keep what the check needs of the run's ``n``-th step."""
        fit, k = divmod(n, self.traffic["fit_steps"])
        steps = self.traffic["compared_steps"]
        if k >= steps:
            return
        rec = self.fits.setdefault(fit, {"losses": []})
        rec["losses"].append(loss)
        if k == 0:
            rec["grad"] = first_gradient(self.step)
        if k == steps - 1:
            # The port's step returns new tensors, so holding these takes
            # no copy on the card.
            rec["params"] = params
            self.fits, self.compared_fit = {fit: rec}, fit

    def prepare(self, i: int) -> None:
        fit, k = divmod(self.checked + i, self.traffic["fit_steps"])
        if k == 0:
            self.params = self.start(fit)
            self.step.load_state_dict({"params": self.params, "optimizer": {"state": {}}})
        if i in self.profiled:
            self.profiled_params[i] = dict(self.params)

    def run(self, i: int):
        params, loss = self.step(self.params, self.target)
        return params, float(loss)

    def settle(self, i: int, out) -> bool:
        self.params = out[0]
        self.keep(self.checked + i, *out)
        return out[1] == out[1] and abs(out[1]) != float("inf")

    def release(self) -> None:
        self.program = self.step = self.target = self.params = None
        n = self.traffic["fit_steps"]
        by_k = [[] for _ in range(n)]
        for i, t in enumerate(self.unit_seconds):
            by_k[(self.checked + i) % n].append(t)
        self.notes = ["mean step ms by position in the fit: " + " ".join(
            f"{k}:{1e3 * sum(t) / len(t):.3f}" for k, t in enumerate(by_k) if t)]

    def check(self) -> list:
        """The compared fit's first ``compared_steps`` steps against the
        reference's from the same start: each step's loss, the first
        gradient's norm and the parameters' change after the last, by the
        worst leaf; a leaf whose reference gradient is under a thousandth
        of the median leaf's (nought to rounding: Adam moves it by round-off
        alone) is left out of the change.  The ``own_norm`` leaves' first
        gradient is held to its own norm besides."""
        ref_scene, spp = self.truth, self.config["spp"]
        fit, steps = self.compared_fit, self.traffic["compared_steps"]
        rec, start = self.fits[fit], self.start(fit)
        with torch.no_grad():
            target = ref_render.cell_means(ref_scene, self.config, spp, self.render_seed,
                                           max(1, FORWARD_BLOCK_RAYS // spp))
        losses, grads, end = ref_fit.follow(
            ref_scene, self.config, spp, self.render_seed, start, target, self.config["lr"],
            steps, self.config["cell_chunk"], max(1, GRAD_BLOCK_RAYS // spp))
        got_losses, got_end = rec["losses"], rec["params"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses))
        norms = {n: float(grads[n].norm()) for n in self.fields}
        median = statistics.median(norms.values())
        moved = [n for n in self.fields if norms[n] >= 1e-3 * median]
        change = {n: got_end[n] - start[n] for n in moved}
        ref_change = {n: end[n] - start[n] for n in moved}
        lim = self.traffic["limits"]
        self.notes += [f"compared fit {fit} (its first step the run's step "
                       f"{fit * self.traffic['fit_steps']})",
                       f"losses {got_losses} reference {losses}"] + [
            f"leaf {n}: gradient norm {float(rec['grad'][n].norm())!r} reference "
            f"{norms[n]!r}; change norm {float((got_end[n] - start[n]).norm())!r} "
            f"reference {float((end[n] - start[n]).norm())!r}" for n in self.fields]
        checks = [("loss_gap", loss_gap, lim["loss_gap"]),
                  ("grad_gap", norm_gap(rec["grad"], grads, self.fields), lim["grad_gap"]),
                  ("change_gap", norm_gap(change, ref_change, moved), lim["change_gap"])]
        own = [n for n in self.traffic.get("own_norm", ()) if n in self.fields]
        if own:
            checks.append(("own_grad_gap", own_norm_gap(rec["grad"], grads, own),
                           lim["own_grad_gap"]))
        return checks

    def counts(self) -> dict:
        """The work of each profiled step's launches, chunk by chunk,
        counted by the reference at that step's parameters."""
        spp, chunk = self.config["spp"], self.config["cell_chunk"]
        n_sph = int(self.truth.radius.shape[0])
        kernels = {"k2": []}
        replay = set(self.fields) & {"albedo", "emission", "background"}
        if replay:
            kernels["k3"] = []
        if not set(self.fields) <= {"albedo", "emission", "background"}:
            kernels["k7"] = []
        for i in self.profiled:
            if i not in self.profiled_params:
                continue
            scene = with_params(self.truth, self.profiled_params[i])
            for c0 in range(0, self.n_cells, chunk):
                c1 = min(c0 + chunk, self.n_cells)
                with torch.no_grad():
                    _, c = ref_render.cell_sums(scene, self.config, c0, c1, spp, self.render_seed,
                                                count=True)
                launch = dict(c, n_spheres=n_sph, cells=c1 - c0, items=(c1 - c0) * spp)
                for k in kernels:
                    kernels[k].append(launch)
        return kernels
