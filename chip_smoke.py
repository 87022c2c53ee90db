"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

An 800x600 scene with 6 views (5 source views per problem), rendered in
memory from a seed, through ``dpe_mvs_tpu_torch.pipeline.schedule
.process_problem``: round-0 pass A for all 6 problems, then the modal pass B
(``schedule_params(base, 1, 0)``: REFINE_ITER, weak machinery, edges and
geometric consistency) for all 6, reading each problem's priors and its
sources' depths back from the pass-A writeback. Phases:

  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from ``dpe_mvs_tpu_torch/csrc`` (one nvcc per source,
     all at once);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at ragged shapes and in every branch of the row kernels' launch plan
     (rows W in {1, 2, 3, 800, 1024, 70001}, L ragged and aligned, H = 70001,
     inputs at a 4-byte offset, staged and unstaged, the widest staged rows
     (W = 6140, 48 KB of shared memory) and the first too wide (W = 6144), a
     tall staged launch (H = 12672), uint32 words with NaN payloads, +-inf
     columns), gather2d in both of the JAX package's size
     regimes (on 32-bit words carrying NaN payloads, scattered and
     clustered); gather2d timed at the > 6 MB-per-channel case;
  4. render the scene;
  5. pass A, all problems, with the launch counters set to 0 just before and
     read just after; row_gather and bilinear_x must have launched;
  6. problem 0 after pass A, read back through the port's ``io.formats``:
     median relative depth error < 2% and valid share > 50%;
  7. pass B, all problems (edge and label maps from the in-memory stand-in
     ``utils.synthetic.support_maps``), counters set to 0 just before and
     read just after; every kernel must have launched; the weak share before
     pass B must be > 0; problem 0 must meet the same bar and be no worse
     than its pass-A error + 0.003;
  8. each kernel against its plain version again, bit-exact, on the inputs
     captured from the pass-A and pass-B runs. At each run's dominant shape
     the kernel (row_gather and bilinear_x: both variants, unstaged and
     staged), its plain version and one PyTorch library call are timed in
     turns (ABBA), each launch by its own event pair, median of REPS
     launches, L2-cold (a 256 MB scratch buffer written and read before every
     launch) and warm, beside the bound (the larger of the bytes over
     3.35 TB/s and the float32 operations over 67 TFLOP/s), the same bound
     with touched image words counted in whole 32-byte sectors, and the
     launch floor (the same kernel on one row of 4 outputs). Per sweep: the
     sum over every captured shape of problem 0's launches x the kernel's
     cold time, beside the same sum of bounds; for the row kernels both
     variants at every shape, in turns with a second copy of the unstaged
     one (their difference is the timing noise), and the sweep's time for
     each choice of the plan's staging threshold. Then launches per sweep, and
     the warm time of one more pass-B sweep with a synchronised per-stage
     breakdown and the peak device memory.

Exits non-zero, without the result lines, when there is no CUDA device or
any phase fails. The line before the last holds the kernel records as JSON;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

W, H, VIEWS = 800, 600, 6
SEED = 7
REPS = 60                          # launches per timed function (median)
SWEEP_REPS = 50                    # launches per captured shape (per sweep)
# Staging thresholds whose per-sweep time phase 8 reports: the plan stages
# where L >= r * W (inf: never).
REUSE_CHOICES = (0.25, 0.5, 1, 2, 4, 8, 16, float("inf"))
FLUSH_BYTES = 256 * 2**20          # > 5x the 50 MB L2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores (same)
SOURCES = {"row_gather": "dpe_mvs_tpu_torch/csrc/rowgather.cu",
           "bilinear_x": "dpe_mvs_tpu_torch/csrc/rowgather.cu",
           "gather2d": "dpe_mvs_tpu_torch/csrc/gather2d.cu"}
REPLACES = {"row_gather": "dpe_mvs_tpu/ops/rowgather.py:59",
            "bilinear_x": "dpe_mvs_tpu/ops/rowgather.py:122",
            "gather2d": "dpe_mvs_tpu/ops/gather2d.py:86 "
                        "(_gather2d_vmem_kernel) and "
                        "dpe_mvs_tpu/ops/gather2d.py:127 (_gather2d_kernel)"}
LIBRARY = {"row_gather": "torch.gather, int64 index pre-clamped",
           "bilinear_x": "torch.nn.functional.grid_sample (bilinear, "
                         "border, align_corners) on a precomputed grid",
           "gather2d": "advanced indexing imgs[:, iy, ix], int64 indices "
                       "pre-clamped"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


class Capture:
    """Wraps the kernel modules' entry points during a run: counts calls per
    shape signature and keeps a copy of the first inputs of each signature
    (the launch counters are the wrappers' own)."""

    def __init__(self, entries):
        self.entries = entries                 # {name: module}
        self.orig = {n: getattr(m, n) for n, m in entries.items()}
        self.seen = {n: {} for n in entries}

    def _wrap(self, name):
        fn = self.orig[name]
        seen = self.seen[name]

        def wrapped(*args):
            sig = tuple((tuple(a.shape), str(a.dtype)) for a in args)
            rec = seen.get(sig)
            if rec is None:
                seen[sig] = rec = [0, [a.clone() for a in args]]
            rec[0] += 1
            return fn(*args)
        return wrapped

    def counts(self):
        """{name: {signature: calls so far}}."""
        return {n: {sig: rec[0] for sig, rec in seen.items()}
                for n, seen in self.seen.items()}

    def __enter__(self):
        for n, m in self.entries.items():
            setattr(m, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, m in self.entries.items():
            setattr(m, n, self.orig[n])


def time_turns(fns, reps: int = REPS, flush=None):
    """Median ms per call of each function in ``fns`` ({name: callable}),
    each call timed by its own pair of CUDA events, the functions in turns
    (the order, then the order reversed: ABBA). ``flush`` runs before every
    timed call (outside its events). The card first sleeps so that the host
    queues the calls ahead of it and no host time lands between the events."""
    import torch
    names = list(fns)
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[n]()
            b.record()
            pairs[n].append((a, b))
    torch.cuda.synchronize()
    return {n: statistics.median(a.elapsed_time(b) for a, b in p)
            for n, p in pairs.items()}


def bound(name, args, granule: int = 1):
    """(ms, "bytes" or "operations"): the least time the card could take for
    the call, the larger of the bytes it must move over the memory rate and
    its float32 operations over the float32 peak outside the tensor cores.
    Bytes count each index and output word once and each image word that
    these indices touch once (4-byte words throughout). ``granule = 8``
    counts touched image words in whole 32-byte sectors instead, the least
    that device memory can deliver."""
    import torch
    if name == "gather2d":
        imgs, iy, ix = args
        C = imgs.shape[0] if imgs.dim() == 3 else 1
        Hh, Ww = imgs.shape[-2:]
        words = iy.clamp(0, Hh - 1).long() * Ww + ix.clamp(0, Ww - 1).long()
        touched = C * torch.unique(words // granule).numel() * granule
        n_out, ops = C * iy.numel(), 0
    elif name == "row_gather":
        img, ix = args
        Ww = img.shape[1]
        rows = torch.arange(img.shape[0], device=img.device)[:, None]
        words = rows * Ww + ix.clamp(0, Ww - 1).long()
        touched = torch.unique(words // granule).numel() * granule
        n_out, ops = ix.numel(), 0
    else:                                              # bilinear_x
        img, x = args
        Ww = img.shape[1]
        rows = torch.arange(img.shape[0], device=img.device)[:, None]
        x0 = x.clamp(0, Ww - 1).floor().clamp(0, max(Ww - 2, 0)).long()
        words = torch.cat([rows * Ww + x0,
                           rows * Ww + (x0 + 1).clamp(max=Ww - 1)])
        touched = torch.unique(words // granule).numel() * granule
        # Per output: two clamps of x, floor, two clamps of x0, 1 - f,
        # x - x0, two products and a sum.
        n_out, ops = x.numel(), 10 * x.numel()
    n_idx = args[1].numel() * (len(args) - 1)
    t_bytes = 4 * (touched + n_idx + n_out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(name, args):
    """One PyTorch call computing the kernel's function on the same data
    (its index preparation done beforehand, outside the timing)."""
    import torch
    if name == "row_gather":
        img, ix = args
        idx = ix.clamp(0, img.shape[1] - 1).long()
        return lambda: torch.gather(img, 1, idx)
    if name == "bilinear_x":
        img, x = args
        Hh, Ww = img.shape
        rows = torch.arange(Hh, device=img.device, dtype=torch.float32)
        gy = (2.0 * rows / max(Hh - 1, 1) - 1.0)[:, None].expand_as(x)
        gx = 2.0 * x / max(Ww - 1, 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1)[None]
        inp = img[None, None]
        return lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode="border",
            align_corners=True)
    imgs, iy, ix = args
    Hh, Ww = imgs.shape[-2:]
    iy64, ix64 = iy.clamp(0, Hh - 1).long(), ix.clamp(0, Ww - 1).long()
    words = imgs.view(torch.int32) if imgs.dtype == torch.uint32 else imgs
    if words.dim() == 2:
        return lambda: words[iy64, ix64]
    return lambda: words[:, iy64, ix64]


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    device = torch.device("cuda")
    t_start = time.time()

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from dpe_mvs_tpu_torch.config import EngineConfig, PatchMatchParams, \
        schedule_params
    from dpe_mvs_tpu_torch.engine import rectcost
    from dpe_mvs_tpu_torch.io import formats
    from dpe_mvs_tpu_torch.ops import cudalib
    from dpe_mvs_tpu_torch.ops import gather2d as g2d
    from dpe_mvs_tpu_torch.ops import rowgather as rg
    from dpe_mvs_tpu_torch.pipeline import schedule as sch
    from dpe_mvs_tpu_torch.utils.synthetic import make_plane_scene, \
        support_maps
    modules = {"row_gather": rg, "bilinear_x": rg, "gather2d": g2d}
    plain = {"row_gather": rg.row_gather_ref, "bilinear_x": rg.bilinear_x_ref,
             "gather2d": g2d.gather2d_ref}

    def reset():
        rg.reset_launches()
        g2d.reset_launches()

    def launches():
        return {**rg.LAUNCHES, **g2d.LAUNCHES}

    phase("2. build kernels")
    t0 = time.time()
    sos = cudalib.build_many([rg.SOURCE, g2d.SOURCE], verbose=True)
    print(f"built {', '.join(p.name for p in sos)} in "
          f"{time.time() - t0:.1f} s")

    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)

    def flush():
        """Write, then read, FLUSH_BYTES: L2 ends up holding clean lines of
        the scratch buffer and none of the kernel's data."""
        scratch.fill_(1.0)
        scratch.sum()

    def exact(name, a, b, where):
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"{name} differs from its plain version at {where}")

    def variant(name, staged, *args):
        """A row kernel in the plan's variant (staged None, the public
        wrapper) or the one staged asks for."""
        if staged is None:
            return getattr(rg, name)(*args)
        return rg._launch(name, *args, staged=staged)

    def off4(t):
        """A contiguous copy of t that starts 4 bytes past a 16-byte
        boundary."""
        flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
        return flat[1:1 + t.numel()].view(t.shape).copy_(t)

    phase("3. kernels vs plain versions, ragged shapes")
    g = torch.Generator(device=device).manual_seed(SEED)
    # Ragged shapes, then the launch plan's shape classes: word I/O (L = 37)
    # and vector I/O (L = 64); rows staged by bulk copy (W % 4 == 0) or read
    # through __ldg (unstaged, W % 4 != 0, W = 70001 past the stage budget);
    # tall arrays (H = 70001) with word and vector I/O; the widest staged
    # rows (48 KB of shared memory with the barriers), the first rows too
    # wide to stage, a tall staged launch.
    shapes = [(1, 1, 1), (3, 1, 5), (7, 5, 33), (257, 130, 1000),
              (70001, 9, 3), (70001, 8, 8), (3, 6140, 12280),
              (3, 6144, 12288), (12672, 1024, 2048)] + \
        [(5 if w == 70001 else 33, w, l)
         for w in (1, 2, 3, 800, 1024, 70001) for l in (37, 64)]
    n_rg = 0
    for (h, w, l) in shapes + [(40, 1024, 2048)]:
        img = torch.rand(h, w, device=device, generator=g) * 255
        x = torch.rand(h, l, device=device, generator=g) * (w + 20) - 10
        ix = torch.floor(x).to(torch.int32)
        x.view(-1)[::5] = float("inf")
        x.view(-1)[1::7] = float("-inf")
        words = torch.randint(-2**31, 2**31 - 1, (h, w), device=device,
                              generator=g, dtype=torch.int32)
        words[:, ::3] = 0x7FC00001                       # quiet-NaN payload
        sets = [(img, x, ix, words)]
        if (h, w, l) == (40, 1024, 2048):                # 4-byte offsets
            sets = [tuple(off4(t) for t in sets[0])]
        for (im, xx, ii, wd) in sets:
            for staged in (None, False, True):
                where = f"({h}, {w}, {l}), staged={staged}, " \
                        f"offset {im.data_ptr() % 16}"
                exact("bilinear_x", variant("bilinear_x", staged, im, xx),
                      rg.bilinear_x_ref(im, xx), where)
                exact("row_gather f32", variant("row_gather", staged, im, ii),
                      rg.row_gather_ref(im, ii), where)
                exact("row_gather u32",
                      variant("row_gather", staged, wd.view(torch.uint32), ii),
                      rg.row_gather_ref(wd, ii), where)
                n_rg += 3
    # gather2d: a channel <= 6 MB and > 6 MB (the JAX package's two TPU
    # kernels), ragged, int32 words with NaN payloads, clustered and
    # scattered queries.
    n_g = 0
    big = None
    for (c, h, w, qh, qw) in [(1, 1, 1, 1, 1), (3, 17, 29, 5, 33),
                              (6, 600, 800, 1201, 803),
                              (9, 1920, 2048, 9600, 1600),
                              (17, 70, 33, 129, 257)]:
        words = torch.randint(-2**31, 2**31 - 1, (c, h, w), device=device,
                              generator=g, dtype=torch.int32)
        words[:, ::3] = 0x7FC00001                       # quiet-NaN payload
        imgs = words.view(torch.float32)
        for clustered in (True, False):
            if clustered:
                yy = torch.arange(qh, device=device)[:, None] * h // qh
                xx = torch.arange(qw, device=device)[None, :] * w // qw
                iy = (yy + torch.randint(-6, 6, (qh, qw), device=device,
                                         generator=g)).to(torch.int32)
                ix = (xx + torch.randint(-9, 9, (qh, qw), device=device,
                                         generator=g)).to(torch.int32)
            else:
                iy = torch.randint(-3, h + 3, (qh, qw), device=device,
                                   generator=g, dtype=torch.int32)
                ix = torch.randint(-3, w + 3, (qh, qw), device=device,
                                   generator=g, dtype=torch.int32)
            for im in (imgs, words):
                exact("gather2d", g2d.gather2d(im, iy, ix),
                      g2d.gather2d_ref(im, iy, ix),
                      f"({c}, {h}, {w}) x ({qh}, {qw})")
                n_g += 1
            if c == 9 and clustered:
                big = (words, iy, ix)
    print(f"row_gather, bilinear_x bit-exact in {n_rg} cases ("
          f"{len(shapes) + 1} shapes x 3 plan variants); gather2d bit-exact "
          f"in {n_g} cases")
    # Row 4 of the TPU kernel table: gather2d with a channel > 6 MB (the
    # JAX package's _gather2d_kernel regime), clustered queries.
    t4 = {v: time_turns({"kernel": lambda: g2d.gather2d(*big),
                         "library": library_call("gather2d", big),
                         "plain": lambda: g2d.gather2d_ref(*big)},
                        flush=fl)
          for v, fl in (("cold", flush), ("warm", None))}
    b4, b4_by = bound("gather2d", big)
    s4 = bound("gather2d", big, granule=8)[0]
    print(f"gather2d > 6 MB per channel (9 x 1920x2048 int32 words, 9600x1600 "
          f"clustered queries): kernel cold {t4['cold']['kernel']:.4f} / warm "
          f"{t4['warm']['kernel']:.4f} ms, plain {t4['cold']['plain']:.4f} / "
          f"{t4['warm']['plain']:.4f} ms, library {t4['cold']['library']:.4f}"
          f" / {t4['warm']['library']:.4f} ms ({LIBRARY['gather2d']}), bound "
          f"{b4:.4f} ms ({b4_by}), {s4:.4f} ms in whole 32-byte sectors, "
          f"cold share of bound {b4 / t4['cold']['kernel']:.0%}")
    del big

    phase("4. render scene")
    t0 = time.time()
    sc = make_plane_scene(width=W, height=H, num_views=VIEWS, seed=SEED)
    print(f"{W}x{H}x{VIEWS} in {time.time() - t0:.1f} s")

    base = PatchMatchParams()
    params_a = schedule_params(base, 0, None)
    params_b = schedule_params(base, 1, 0)
    cfg = EngineConfig(seed=SEED)
    v_pad = VIEWS - 1
    out_dir = Path(tempfile.mkdtemp(prefix="dpe_smoke_"))
    problems = [sch.Problem(result_folder=out_dir / f"{i:08d}",
                            ref_image_id=i) for i in range(VIEWS)]

    def folders(p):
        ids = [p.ref_image_id] + sc.src_ids(p.ref_image_id)
        return [problems[i].result_folder for i in ids]

    def depth_stats(p):
        depth = formats.read_dmb(p.result_folder / "depths.dmb")
        gt = sc.gt_depths[p.ref_image_id]
        if depth.shape != gt.shape or not np.isfinite(depth).all():
            fail(f"problem {p.ref_image_id}: bad depth map")
        ok = depth > 0
        med = float(np.median(np.abs(depth[ok] - gt[ok]) / gt[ok])) \
            if ok.any() else float("inf")
        return med, float(ok.mean())

    phase("5. pass A, all problems")
    for p in problems:
        st = rectcost.build_rect_host(sc.problem_inputs(p.ref_image_id)
                                      .cameras, W, H, v_pad).statics
        print(f"problem {p.ref_image_id}: rect frame {st.wp}x{st.hp}")

    def sweep(p, params, **kw):
        """One sweep of problem p; prints its time and its kernel launches
        and returns the launches."""
        before = launches()
        tp = time.time()
        sch.process_problem(p, params, 1, 1, v_pad, cfg, device=device, **kw)
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in launches().items()}
        print(f"problem {p.ref_image_id}: {time.time() - tp:.2f} s, "
              f"launches {n}")
        return n

    reset()
    t0 = time.time()
    per_sweep_a = None
    with Capture(modules) as cap_a:
        for p in problems:
            n = sweep(p, params_a, inputs=sc.problem_inputs(p.ref_image_id))
            if per_sweep_a is None:        # problem 0: launches per shape
                per_sweep_a, counts_a = n, cap_a.counts()
    launches_a = launches()
    print(f"all problems: {time.time() - t0:.2f} s (first includes warm-up)")
    print(f"launches: {launches_a}")
    for name in ("row_gather", "bilinear_x"):
        if launches_a[name] <= 0:
            fail(f"kernel {name} was not launched by pass A")

    phase("6. result of problem 0 after pass A")
    med_a, valid_a = depth_stats(problems[0])
    print(f"median rel depth error {med_a:.5f}, valid {valid_a:.4f}")
    if not (med_a < 0.02 and valid_a > 0.5):
        fail("problem 0 misses the ground-truth bar after pass A "
             "(median < 2%, valid > 50%)")
    for p in problems[1:]:
        depth_stats(p)

    phase("7. pass B, all problems")

    def pass_b_inputs(p):
        inp = sch.add_pass_inputs(sc.problem_inputs(p.ref_image_id),
                                  p.result_folder, folders(p),
                                  **sch.pass_needs(params_b))
        return inp, support_maps(inp.images[0])

    reset()
    t0 = time.time()
    per_sweep_b = None
    with Capture(modules) as cap_b:
        for p in problems:
            inp, maps = pass_b_inputs(p)
            weak_share = float((inp.weak_info == 0).mean())
            print(f"problem {p.ref_image_id}: weak share before pass B "
                  f"{weak_share:.4f}, edge share {float(maps[0].mean()):.4f}, "
                  f"labelled {float((maps[2] > 0).mean()):.4f}")
            if p.ref_image_id == 0 and weak_share <= 0.0:
                fail("problem 0 has no weak pixels before pass B")
            p.iteration = 1
            n = sweep(p, params_b, inputs=inp, support_maps=maps)
            if per_sweep_b is None:
                per_sweep_b, counts_b = n, cap_b.counts()
    launches_b = launches()
    print(f"all problems: {time.time() - t0:.2f} s (first includes warm-up)")
    print(f"launches: {launches_b}")
    for name, n in launches_b.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by pass B")
    med_b, valid_b = depth_stats(problems[0])
    print(f"problem 0 after pass B: median rel depth error {med_b:.5f}, "
          f"valid {valid_b:.4f} (pass A {med_a:.5f})")
    if not (med_b < 0.02 and valid_b > 0.5 and med_b <= med_a + 0.003):
        fail("problem 0 misses the bar after pass B (median < 2%, valid > "
             "50%, no worse than pass A + 0.003)")
    for p in problems[1:]:
        depth_stats(p)

    phase("8. kernels at the main paths' shapes; warm sweep")

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count

    def check(name, seen, sweep_name):
        """Bit-exact against the plain version at every captured shape."""
        fn = getattr(modules[name], name)
        for sig, (n, args) in seen.items():
            exact(name, fn(*args), plain[name](*args), f"{sig} ({sweep_name})")

    def time_dominant(name, seen, sweep_name):
        """Kernel variants, library call and plain version in turns at the
        dominant shape (the most elements over the run), L2-cold and warm."""
        sig, (n, args) = max(seen.items(),
                             key=lambda kv: kv[1][0] * kv[1][1][1].numel())
        fn = getattr(modules[name], name)
        if name == "gather2d":
            fns, chosen = {"kernel": lambda: fn(*args)}, "kernel"
        else:
            fns = {"unstaged": lambda: rg._launch(name, *args, staged=False),
                   "staged": lambda: rg._launch(name, *args, staged=True)}
            img, idx = args
            chosen = "staged" if rg.launch_plan(
                *img.shape, idx.shape[1], img.data_ptr(), idx.data_ptr(), 0,
                n_sm).staged else "unstaged"
        kinds = list(fns)
        fns["library"] = library_call(name, args)
        fns["plain"] = lambda: plain[name](*args)
        # The launch floor: the same kernel on one row of 4 outputs.
        tiny = [a[..., :1, :4].contiguous() for a in args]
        fns["floor"] = lambda: fn(*tiny)
        cold = time_turns(fns, flush=flush)
        warm = time_turns(fns)
        b_ms, b_by = bound(name, args)
        s_ms = bound(name, args, granule=8)[0]
        print(f"{name}, {sweep_name}: dominant {sig} x{n}; bound {b_ms:.4f} "
              f"ms ({b_by}), {s_ms:.4f} ms in whole 32-byte sectors; launch "
              f"floor (1 x 4 outputs) {cold['floor']:.4f} / "
              f"{warm['floor']:.4f} ms; cold / warm ms, share of bound "
              f"(cold):")
        for k in [*kinds, "library", "plain"]:
            mark = " (chosen)" if k == chosen and len(kinds) > 1 else ""
            lib = f" ({LIBRARY[name]})" if k == "library" else ""
            print(f"  {k}{mark}{lib}: {cold[k]:.4f} / {warm[k]:.4f}, "
                  f"{b_ms / cold[k]:.0%}")
        rec = {"ms": warm[chosen], "cold_ms": cold[chosen],
               "plain_ms": warm["plain"], "plain_cold_ms": cold["plain"],
               "library_ms": warm["library"],
               "library_cold_ms": cold["library"],
               "bound_ms": b_ms, "bound_by": b_by, "sector_bound_ms": s_ms,
               "floor_ms": cold["floor"]}
        if len(kinds) > 1:
            rec["variant"] = chosen
            rec["variants"] = {k: {"ms": warm[k], "cold_ms": cold[k]}
                               for k in kinds}
        return rec

    def per_sweep(name, seen, counts0, sweep_name):
        """Problem 0's sweep: over every captured shape, its launches x the
        kernel's cold time (median of SWEEP_REPS) and the same sum of
        bounds. The row kernels time both variants at every shape, in turns
        with a second copy of the unstaged one, and sum the sweep for each
        staging threshold in REUSE_CHOICES. Returns the record's fields."""
        fn = getattr(modules[name], name)
        row = name != "gather2d"
        sums = {"plan": 0.0, "bound": 0.0}
        if row:
            sums.update({"unstaged": 0.0, "staged": 0.0, "unstaged_again": 0.0,
                         **{r: 0.0 for r in REUSE_CHOICES}})
        for sig, (n, args) in seen.items():
            c = counts0[name].get(sig, 0)
            if not c:
                continue
            sums["bound"] += c * bound(name, args)[0]
            if not row:
                sums["plan"] += c * time_turns(
                    {"k": lambda: fn(*args)}, reps=SWEEP_REPS,
                    flush=flush)["k"]
                continue
            t = time_turns(
                {"unstaged": lambda: rg._launch(name, *args, staged=False),
                 "staged": lambda: rg._launch(name, *args, staged=True),
                 "unstaged_again":
                     lambda: rg._launch(name, *args, staged=False)},
                reps=SWEEP_REPS, flush=flush)
            img, idx = args
            (Hh, Ww), L = img.shape, idx.shape[1]

            def plan_staged(r):
                return rg.launch_plan(Hh, Ww, L, img.data_ptr(),
                                      idx.data_ptr(), 0, n_sm, L >= r * Ww
                                      ).staged
            for k in ("unstaged", "staged", "unstaged_again"):
                sums[k] += c * t[k]
            for r in REUSE_CHOICES:
                sums[r] += c * t["staged" if plan_staged(r) else "unstaged"]
            sums["plan"] += c * t["staged" if plan_staged(rg.STAGE_MIN_REUSE)
                                  else "unstaged"]
        t, b = sums["plan"], sums["bound"]
        print(f"{name}, {sweep_name}: per sweep (problem 0, "
              f"{sum(counts0[name].values())} launches over "
              f"{len(counts0[name])} shapes) {t:.3f} ms cold, bound "
              f"{b:.3f} ms ({b / t:.0%})")
        rec = {"sweep_ms": t, "sweep_bound_ms": b}
        if row:
            print(f"  per sweep, every shape in one variant: unstaged "
                  f"{sums['unstaged']:.3f} ms, staged {sums['staged']:.3f} "
                  f"ms, unstaged again {sums['unstaged_again']:.3f} ms "
                  f"(noise {abs(sums['unstaged'] - sums['unstaged_again']):.3f}"
                  f" ms)")
            print("  per sweep, staged where L >= r W: " + ", ".join(
                f"r={r:g} {sums[r]:.3f}" for r in REUSE_CHOICES) +
                f" ms (plan: r={rg.STAGE_MIN_REUSE:g})")
            rec["sweep_variants"] = {
                **{k: sums[k] for k in ("unstaged", "staged",
                                        "unstaged_again")},
                "by_reuse": {f"{r:g}": sums[r] for r in REUSE_CHOICES}}
        return rec

    def measure(name, seen, counts0, sweep_name):
        check(name, seen, sweep_name)
        print(f"{name}, {sweep_name}: {len(seen)} shapes bit-exact")
        rec = time_dominant(name, seen, sweep_name)
        rec.update(per_sweep(name, seen, counts0, sweep_name))
        return rec

    recs = {(name, "pass A"): measure(name, cap_a.seen[name], counts_a,
                                      "pass A")
            for name in ("row_gather", "bilinear_x")}
    recs.update({(name, "pass B"): measure(name, cap_b.seen[name], counts_b,
                                           "pass B")
                 for name in ("row_gather", "bilinear_x", "gather2d")})
    kernels = []
    for name in ("row_gather", "bilinear_x", "gather2d"):
        print(f"{name}: launches per sweep (problem 0) pass A "
              f"{per_sweep_a[name]}, pass B {per_sweep_b[name]}; all "
              f"problems pass A {launches_a[name]}, pass B {launches_b[name]}")
        rec = recs[name, "pass B"]
        if (name, "pass A") in recs:
            ra = recs[name, "pass A"]
            rec["pass_a"] = {k: ra[k] for k in
                             ("ms", "cold_ms", "bound_ms", "library_ms",
                              "library_cold_ms", "plain_ms", "sweep_ms",
                              "sweep_bound_ms", "sweep_variants")}
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches_b[name], "max_abs_err": 0.0,
                        **rec})
    del cap_a, cap_b, scratch

    p0 = problems[0]
    p0.iteration = 2
    inp0, maps0 = pass_b_inputs(p0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sch.process_problem(p0, params_b, 1, 1, v_pad, cfg, device=device,
                        inputs=inp0, support_maps=maps0)
    torch.cuda.synchronize()
    warm = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"warm pass-B sweep (incl. rectification and writeback): "
          f"{warm:.3f} s; peak memory {peak / 2**20:.1f} MiB")

    spans = {}

    @contextlib.contextmanager
    def timer(name):
        torch.cuda.synchronize()
        ts = time.time()
        yield
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.time() - ts

    inp0, maps0 = pass_b_inputs(p0)
    sch.process_problem(p0, params_b, 1, 1, v_pad, cfg, device=device,
                        inputs=inp0, support_maps=maps0, timer=timer)
    print("pass-B stages (s, synchronised): " +
          ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    print(f"script time {time.time() - t_start:.1f} s")

    shutil.rmtree(out_dir, ignore_errors=True)
    if "jax" in sys.modules or any(m.startswith("dpe_mvs_tpu.")
                                   or m == "dpe_mvs_tpu"
                                   for m in sys.modules):
        fail("the port imported jax or the JAX package")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
