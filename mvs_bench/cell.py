"""One cell of the benchmark: set-up, the measured window and what the
check needs, driving the program through
``dpe_mvs_tpu_torch.pipeline.schedule.process_problem`` as the round loop
(``run_pipeline``) calls it for one pass of one round.

Set-up (counted in ``setup_s``):
  1. build the program's kernels (cached in its ``_build/`` after the
     checkout's first run);
  2. render the cell's scene from the seed (:mod:`.scene`) and write it as a
     dense folder in the run's temporary directory;
  3. compute the round's edge and label maps through the program's
     ``get_problem_edges`` for the views it sweeps (and the coarsest
     scale's edges where the profile reads them);
  4. write every view's truth at the previous round's size as that round's
     output, and, for a pass B, run the round's pass A over every view, as
     the round loop does before its passes B;
  5. load the first problem's inputs.

The window then cycles over the traffic's problems, one sweep each, the next
problem's inputs loaded on one prefetch thread while the current one sweeps
and, in a geometric pass, the sources' depth maps read just before the
sweep, so that each sweep reads what the sweeps before it wrote. What a
sweep wrote back is kept by hard links and read once the window has closed.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import probes, reference, scene as scene_mod
from .probes import KernelProbe
from .window import Window, run_window


MAP_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


@dataclasses.dataclass
class CellSpec:
    name: str
    config: dict
    traffic: dict


def pass_geom(traffic: dict) -> Optional[int]:
    """The round loop's ``geom_pass`` of the traffic's pass: None for pass
    A, 0-2 for the passes B."""
    return None if traffic["pass"] == "A" else int(traffic["geom_pass"])


class CellRun:
    """A cell's run on ``device``, its scene written under ``workdir``."""

    def __init__(self, spec: CellSpec, seed: int, device: str, workdir: Path,
                 log=print) -> None:
        self.spec = spec
        self.seed = seed
        self.device = device
        self.workdir = Path(workdir)
        self.log = log
        self.info: Dict[str, float] = {}
        self.maps: List[reference.SweepMaps] = []
        self.pending: List[tuple] = []     # (view, {file: link}) per sweep
        self.pixels: List[int] = []
        self.sweep_s: List[float] = []

    # ------------------------------------------------------------------
    def setup(self) -> None:
        import torch
        from dpe_mvs_tpu_torch import config as pcfg
        from dpe_mvs_tpu_torch.io import scene as pscene
        from dpe_mvs_tpu_torch.ops import gather2d, rowgather
        from dpe_mvs_tpu_torch.pipeline import schedule

        self.torch, self.pscene, self.schedule = torch, pscene, schedule
        conf, traffic = self.spec.config, self.spec.traffic
        t = time.perf_counter()
        if torch.device(self.device).type == "cuda":
            rowgather.build()
            gather2d.build()
            torch.cuda.init()
        self._stamp("build", t)

        t = time.perf_counter()
        W, H = conf["frame"]
        # A traffic that fixes its scene's seed gives every run the same
        # work; the run's seed then draws only what the check samples.
        self.scene = scene_mod.make_plane_scene(
            width=W, height=H, num_views=conf["views"],
            weak_patch=bool(traffic["scene"].get("weak_patch", False)),
            seed=int(traffic["scene"].get("seed", self.seed)))
        self._stamp("render", t)
        t = time.perf_counter()
        self.folder = scene_mod.write_scene_folder(
            self.scene, self.workdir / "scene")
        self._stamp("folder", t)

        cfg = pcfg.EngineConfig(profile=pcfg.PROFILES[conf["profile"]])
        self.cfg = cfg
        problems = pscene.generate_sample_list(self.folder)
        round_num = schedule.compute_round_num(problems, cfg)
        if round_num != conf["rounds"]:
            raise RuntimeError(f"{conf['name']}: the program plans "
                               f"{round_num} rounds, the config {conf['rounds']}")
        r = int(traffic["round"])
        scale_sizes = [2 ** (round_num - 1 - i) for i in range(round_num)]
        self.scale_size = scale_sizes[r]
        self.max_scale = schedule.scale_index(max(scale_sizes))
        base = cfg.profile.apply(pcfg.PatchMatchParams())
        self.base = base
        self.params = pcfg.schedule_params(base, r, pass_geom(traffic))
        self.v_pad = max(max(min(len(p.src_image_ids), cfg.max_images - 1)
                             for p in problems), 1)
        self.problems = problems
        self.order = [int(v) for v in traffic["problems"]]
        # Before its passes B the round loop sweeps pass A over every view.
        self.setup_views = (list(range(len(problems)))
                            if pass_geom(traffic) is not None else [])
        self.iteration = 4 * r + (0 if pass_geom(traffic) is None
                                  else 1 + pass_geom(traffic))

        # The round's edge and label maps (and the coarsest scale's edges,
        # which a high-resolution profile reads), for the swept problems.
        t = time.perf_counter()
        sizes = {self.scale_size}
        if base.high_res_img and (self.params.use_APD or self.params.use_edge):
            sizes.add(2 ** self.max_scale)
        jobs = [(problems[v], s)
                for v in sorted(set(self.order) | set(self.setup_views))
                for s in sorted(sizes)]
        with cf.ThreadPoolExecutor(min(len(jobs), 8)) as pool:
            list(pool.map(lambda j: schedule.get_problem_edges(j[0], j[1],
                                                                base), jobs))
        self._stamp("edges", t)

        # The previous round's output: every view's truth at its size.
        t = time.perf_counter()
        step = self.scale_size * 2
        for v in range(len(problems)):
            scene_mod.write_coarse_priors(self.scene, v,
                                          problems[v].result_folder, step)
        self.rect_frame = (schedule.round_rect_frame(problems,
                                                     self.scale_size,
                                                     self.v_pad)
                           if schedule.use_rect_engine(cfg)
                           and len(problems) > 1 else None)
        self._stamp("priors", t)

        if pass_geom(traffic) is not None:
            t = time.perf_counter()
            params_a = pcfg.schedule_params(base, r, None)
            self._sweeps(params_a, 4 * r, self.setup_views, timer=None)
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize()
            self._stamp("pass_a", t)

        # The priors the window's first sweeps start from.
        self.last = {v: self.read_prior(v) for v in self.order}

    def read_prior(self, v: int):
        """View ``v``'s depth and source bitmask as they stand, at the
        round's size."""
        W, H = self.spec.config["frame"]
        cols, rows = reference.scaled_size(W, H, self.scale_size)
        rf = self.problems[v].result_folder
        return tuple(reference.nearest_rescale(scene_mod.read_dmb(rf / f),
                                               cols, rows)
                     for f in ("depths.dmb", "selected_views.bin"))

    def _stamp(self, name: str, t0: float) -> None:
        self.info[name + "_s"] = time.perf_counter() - t0
        self.log(f"set-up {name}: {self.info[name + '_s']:.3f} s")

    def _needs(self, params) -> dict:
        return self.schedule.pass_needs(params)

    def _load(self, params, p):
        # All but the sources' depth maps, which the sweep running
        # meanwhile may be writing (as the round loop loads them).
        return self.pscene.load_problem_inputs(
            p, self.scale_size,
            **{**self._needs(params), "need_src_depths": False})

    def _sweep_one(self, params, iteration, p, inputs, timer):
        span = timer if timer is not None else (
            lambda name: contextlib.nullcontext())
        if self._needs(params)["need_src_depths"]:
            with span("load"):
                inputs = self.pscene.add_pass_inputs(
                    inputs, p.result_folder, self.pscene.view_folders(p),
                    need_prior=False, need_weak=False, need_src_depths=True)
        p.iteration = iteration
        self.schedule.process_problem(
            p, params, self.scale_size, self.max_scale, self.v_pad, self.cfg,
            device=self.device, verbose=False, inputs=inputs,
            rect_frame=self.rect_frame, timer=timer)

    def _sweeps(self, params, iteration, views, timer) -> None:
        """One sweep of each of ``views`` in the round loop's way."""
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._load, params, self.problems[views[0]])
            for i, v in enumerate(views):
                inputs = fut.result()
                if i + 1 < len(views):
                    fut = pool.submit(self._load, params,
                                      self.problems[views[i + 1]])
                self._sweep_one(params, iteration, self.problems[v], inputs,
                                timer)

    # ------------------------------------------------------------------
    def measure(self, seconds: float, probe: KernelProbe, timer=None,
                window_range=None) -> Window:
        """The measured window. ``timer`` (traced run) is passed to the
        program; ``window_range`` (a context manager) marks the window in
        the trace."""
        torch = self.torch
        cuda = torch.device(self.device).type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        n = len(self.order)
        pool = cf.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self._load, self.params,
                          self.problems[self.order[0]])
        fut.result()
        sync()
        self.setup_peak = (torch.cuda.max_memory_allocated() if cuda else 0)
        if cuda:
            torch.cuda.reset_peak_memory_stats()

        def sweep(k: int) -> None:
            nonlocal fut
            v = self.order[k % n]
            p = self.problems[v]
            inputs = fut.result()
            fut = pool.submit(self._load, self.params,
                              self.problems[self.order[(k + 1) % n]])
            probe.start_sweep()
            t0 = time.perf_counter()
            self._sweep_one(self.params, self.iteration, p, inputs, timer)
            sync()
            self.sweep_s.append(time.perf_counter() - t0)
            self._capture(v, inputs.width * inputs.height)

        try:
            with (window_range or contextlib.nullcontext()):
                win = run_window(sweep, seconds)
        finally:
            probe.finish()
            fut.cancel()
            pool.shutdown(wait=True)
        self.read_captures()
        return win

    def _capture(self, v: int, pixels: int) -> None:
        """Keep what the sweep wrote back: a hard link to each file. The
        program writes a file aside and renames it into place, so a link
        holds this sweep's file whole after a later sweep has written its
        own; :meth:`read_captures` reads them once the window has closed."""
        rf = Path(self.problems[v].result_folder)
        keep = self.workdir / "captured"
        keep.mkdir(exist_ok=True)
        links = {}
        for f in MAP_FILES:
            dst = keep / f"{len(self.pending) + len(self.maps):04d}.{f}"
            try:
                os.link(rf / f, dst)
            except OSError:               # a file system without links
                shutil.copyfile(rf / f, dst)
            links[f] = dst
        self.pending.append((v, links))
        self.pixels.append(pixels)

    def read_captures(self) -> None:
        """Read the kept maps, each beside the prior its sweep started
        from (the set-up's, or what the view's previous sweep wrote)."""
        for v, links in self.pending:
            depth = scene_mod.read_dmb(links["depths.dmb"])
            selected = scene_mod.read_dmb(links["selected_views.bin"])
            self.maps.append(reference.SweepMaps(
                view=v, depth=depth,
                normal=scene_mod.read_dmb(links["normals.dmb"]),
                weak=scene_mod.read_dmb(links["weak.bin"]),
                selected=selected, prior_depth=self.last[v][0],
                prior_selected=self.last[v][1]))
            self.last[v] = (depth, selected)
            for p in links.values():
                p.unlink()
        self.pending = []


def kernel_numbers(probe: KernelProbe) -> Dict[str, float]:
    """The kernel layer's numbers: elements of the copied launches that
    differ from the plain gathers, and entries that launched with no launch
    copied."""
    bad = 0
    for c in probe.captures:
        args = tuple(probes.host(a) for a in c.args)
        ref = reference.kernel_reference(c.name, args)
        bad += reference.mismatches(probes.host(c.out), ref)
    return {"kernel_mismatch": float(bad),
            "kernel_missing": float(len(probe.missing()))}


def control_replace(name: str, args):
    """The control: the plain gather computed in bfloat16 on the card, in
    place of the kernel."""
    import torch
    return reference.kernel_reference(name, args, dtype=torch.bfloat16)


def check_numbers(run: CellRun, probe: KernelProbe, n_cost: int,
                  limits: Dict[str, float]):
    """Every number of the check (:mod:`.reference`), each the worst over
    the window's sweeps, and how many sweeps had a number over its
    limit."""
    rng = np.random.default_rng([run.seed, 2])
    views = sorted({v for m in run.maps
                    for v in [m.view] + run.scene.src_ids(m.view)})
    images = reference.images_at_round(run.scene, views, run.scale_size)
    per = [reference.sweep_numbers(m, run.scene, run.scale_size,
                                   run.params.top_k, rng, n_cost, images)
           for m in run.maps]
    failed = sum(not all(v["ok"] for k, v in
                         reference.judge(s, limits).items() if k in s)
                 for s in per)
    out = reference.worst(per)
    out.update(kernel_numbers(probe))
    return out, failed
