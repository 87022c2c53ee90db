"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The suite runs under pytest-xdist with several workers, so torch is held to
one thread per worker. JAX is imported lazily, so that the GPU-marked tests
of a file can run where only torch is installed.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


class JaxKey:
    """The port's key protocol (``split``, ``fold_in``, ``uniform``,
    ``randint``) backed by ``jax.random`` on the CPU: port functions given a
    JaxKey draw the very numbers the JAX functions draw from the same JAX
    key."""

    def __init__(self, key):
        self.key = key

    def split(self, n: int = 2):
        import jax
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i) -> "JaxKey":
        import jax
        return JaxKey(jax.random.fold_in(self.key, int(i)))

    def uniform(self, shape, lo=0.0, hi=1.0) -> torch.Tensor:
        import jax
        import jax.numpy as jnp

        def arr(v):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            return jnp.asarray(np.asarray(v, np.float32))

        u = jax.random.uniform(self.key, tuple(shape), minval=arr(lo),
                               maxval=arr(hi))
        return torch.from_numpy(np.array(u))

    def randint(self, shape, lo, hi) -> torch.Tensor:
        import jax
        r = jax.random.randint(self.key, tuple(shape), int(lo), int(hi))
        return torch.from_numpy(np.array(r))


def assert_costs_close(out, ref, atol=1e-4, frac=0.999, atol_max=2e-4):
    """Costs in [0, 2] agree to ``atol`` on at least ``frac`` of the entries
    and to ``atol_max`` everywhere.

    The NCC's one-pass float32 variances (E[x^2] - E[x]^2) amplify ulp-level
    differences in the window sums at low-texture windows: the JAX package's
    own jitted and op-by-op evaluations of one cost field differ by up to
    1.5e-4 on the test scenes, so no port can be held tighter everywhere."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    d = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    assert float(d.max()) <= atol_max, float(d.max())
    assert float((d <= atol).mean()) >= frac, float((d <= atol).mean())


def to_numpy(tree):
    """A JAX pytree with numpy leaves (PRNG keys are kept as they are)."""
    import jax

    def leaf(x):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            return x
        return np.array(x)
    return jax.tree.map(leaf, tree)


def port_inputs(data_j, views_j, device="cpu"):
    """Port SweepData (with rect views) holding the JAX inputs' values."""
    from dpe_mvs_tpu_torch.engine import state as tst
    rect = tst.rect_views_from_numpy(to_numpy(views_j), device)
    return tst.sweep_data_from_numpy(to_numpy(data_j), device, rect=rect)


def port_statics(statics_j):
    from dpe_mvs_tpu_torch.engine import rectcost as trc
    return trc.RectStatics(f_transposed=statics_j.f_transposed,
                           b_transposed=statics_j.b_transposed,
                           hp=statics_j.hp, wp=statics_j.wp)


def port_params(p):
    """The JAX package's PatchMatchParams as the port's, field by field."""
    import dataclasses
    from dpe_mvs_tpu_torch import config as tcfg
    d = dataclasses.asdict(p)
    d["state"] = tcfg.RunState(int(d["state"]))
    return tcfg.PatchMatchParams(**d)


def port_engine_config(c):
    """The JAX package's EngineConfig as the port's, field by field."""
    import dataclasses
    from dpe_mvs_tpu_torch import config as tcfg
    d = dataclasses.asdict(c)
    d["profile"] = tcfg.DatasetProfile(**d["profile"])
    return tcfg.EngineConfig(**d)


def weak_scene(folder, *, width=48, height=36, views=3, seed=3,
               geom=True, key=11):
    """JAX-side inputs of a later-round sweep on the plane scene with a
    texture-less patch (``weak_patch=True``), at the size the port's weak
    tests use.

    Priors stand in for an earlier sweep's writeback: ground-truth depths
    within +-2% and normals, random selected views, the patch labelled WEAK
    and 3% of the pixels UNKNOWN; the source views' depth maps are their
    ground truth within +-1%. The support maps come from
    ``dpe_mvs_tpu.edges.dual_level`` (fine edges of the image and of its
    half-size copy; coarse labels with the low-resolution threshold, which
    labels regions at this size). ``geom`` selects pass B
    (``schedule_params(base, 1, 0)``) or round-1 pass A
    (``schedule_params(base, 1, None)``)."""
    import types

    import cv2
    import jax
    from dpe_mvs_tpu.config import PatchMatchParams, PixelState, \
        schedule_params
    from dpe_mvs_tpu.edges import dual_level
    from dpe_mvs_tpu.engine import rectcost
    from dpe_mvs_tpu.engine import state as st_mod
    from dpe_mvs_tpu.io import scene as scene_mod
    from dpe_mvs_tpu.utils.synthetic import make_plane_scene

    sc = make_plane_scene(str(folder), width=width, height=height,
                          num_views=views, seed=seed, weak_patch=True)
    problem = scene_mod.generate_sample_list(sc.folder)[0]
    inputs = scene_mod.load_problem_inputs(
        problem, 1, need_prior=False, need_weak=False, need_src_depths=False)
    H, W = height, width
    rng = np.random.default_rng(seed)
    inputs.prior_depth = (sc.gt_depths[0] * rng.uniform(0.98, 1.02, (H, W))
                          ).astype(np.float32)
    inputs.prior_normal = sc.gt_normals[0].astype(np.float32)
    inputs.prior_selected_views = rng.integers(
        1, 2 ** (views - 1), (H, W)).astype(np.int32)
    weak = np.full((H, W), int(PixelState.STRONG), np.uint8)
    weak[sc.weak_region] = int(PixelState.WEAK)
    weak[rng.uniform(size=(H, W)) < 0.03] = int(PixelState.UNKNOWN)
    inputs.weak_info = weak
    inputs.src_depths = np.stack(
        [sc.gt_depths[i] * rng.uniform(0.99, 1.01, (H, W))
         for i in range(views)]).astype(np.float32)

    img = inputs.images[0].astype(np.uint8)
    edge = dual_level.fine_edges(img, True) > 0
    edge_low = dual_level.fine_edges(
        cv2.resize(img, (W // 2, H // 2), interpolation=cv2.INTER_LINEAR),
        True) > 0
    label = dual_level.coarse_labels(img, 0, False)

    params = schedule_params(PatchMatchParams(), 1, 0 if geom else None)
    v_pad = views - 1
    rh = rectcost.build_rect_host(inputs.cameras, W, H, v_pad)
    rviews = rectcost.build_rect_views(
        rh, inputs.images, inputs.src_depths[1:] if geom else None,
        cameras=inputs.cameras)
    data = st_mod.build_sweep_data(inputs, v_pad, edge, edge_low, label)
    st0 = st_mod.init_pm_state(inputs, v_pad, jax.random.key(key), True)
    return types.SimpleNamespace(
        sc=sc, problem=problem, inputs=inputs, maps=(edge, edge_low, label),
        params=params, v_pad=v_pad, rh=rh, views=rviews,
        data=data._replace(rect=rviews), st0=st0)


def xla_cpu_float(monkeypatch):
    """Make torch compute float32 library functions as XLA:CPU does, for the
    duration of a test: ``torch.exp`` and ``torch.sqrt`` through
    ``jax.numpy`` (XLA's own approximations, an ulp from libm's on some
    arguments), and
    ``Tensor.sum`` over given dims in XLA:CPU's order (one running sum for
    up to 32 terms, two halves summed apart for 33-64; the only sizes the
    small test frames reach). Under it the port's NCC costs equal JAX's run
    op by op to an ulp: what is left between them is the library, not the
    port's arithmetic."""
    import jax.numpy as jnp

    plain_sum = torch.Tensor.sum

    def running(a):
        t = a[0]
        for i in range(1, a.shape[0]):
            t = t + a[i]
        return t

    def xla_sum(self, dim=None, *args, **kw):
        if dim is None or not self.is_floating_point():
            return plain_sum(self, dim, *args, **kw)
        x = self
        if isinstance(dim, tuple):
            assert dim == (0, 1), dim
            x, dim = x.flatten(0, 1), 0
        x = x.movedim(dim, 0)
        n = x.shape[0]
        assert n <= 64, n
        if n <= 32:
            return running(x)
        k = -(-n // 2)
        return running(x[:k]) + running(x[k:])

    def xla(fn):
        return lambda x: torch.from_numpy(np.array(fn(jnp.asarray(
            x.numpy()))))

    monkeypatch.setattr(torch.Tensor, "sum", xla_sum)
    monkeypatch.setattr(torch, "exp", xla(jnp.exp))
    monkeypatch.setattr(torch, "sqrt", xla(jnp.sqrt))
