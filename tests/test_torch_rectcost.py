"""The rectified cost engine of the PyTorch port against the JAX package.

  * the numpy ``build_rect_host`` copy: exact (same numpy code);
  * the port's rectification of the images: rtol 1e-5 (bilinear warps, two
    float32 lerps whose multiply-adds XLA fuses);
  * ``rect_cost_vector_stacked`` at stride 1, and at stride 2 with the
    EvalCache, on a fixed plane field, from identical rect views: costs in
    [0, 2] agree to atol 1e-4 on 99.9% of the entries and to 2e-4 everywhere
    (the window sums are accumulated with other fusions; see
    ``torch_parity.assert_costs_close``);
  * ``rect_disparity_sweep`` at strides 1 and 2: the same tolerance;
  * the finish, classify and refine stages from identical state: finish
    (world frame + median filter) to rtol 1e-5; classify labels equal on
    >= 98% of pixels and refined depths within 1e-4 relative on >= 98%
    (both decide by thresholds and argmins over costs that agree to ~1e-4).
"""
import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import rectcost as trc
from dpe_mvs_tpu_torch.engine import stages as tstages
from dpe_mvs_tpu_torch.engine import state as tst
from dpe_mvs_tpu_torch.engine import weak_rect as twr

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams, schedule_params
from dpe_mvs_tpu.engine import patchmatch as pm
from dpe_mvs_tpu.engine import rectcost
from dpe_mvs_tpu.engine import stages
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.engine import weak_rect
from dpe_mvs_tpu.geometry import cameras as geo
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_rectcost_scene")
    sc = make_plane_scene(folder, width=80, height=64, num_views=4, seed=5)
    problems = scene_mod.generate_sample_list(sc.folder)
    inputs = scene_mod.load_problem_inputs(
        problems[0], 1, need_prior=False, need_weak=False,
        need_src_depths=False)
    v_pad = 3
    data = st_mod.build_sweep_data(inputs, v_pad)
    rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                  inputs.height, v_pad)
    views = rectcost.build_rect_views(rh, inputs.images, None,
                                      cameras=inputs.cameras)
    tdata = torch_parity.port_inputs(data, views)
    return sc, inputs, data, rh, views, tdata


def _gt_plane(sc, inputs, noise_seed=0):
    """Ground-truth (n_cam, d) plane field with a little per-pixel noise, so
    the evaluated costs span good and bad matches."""
    cam = geo.Camera(K=jnp.asarray(inputs.cameras[0].K),
                     R=jnp.asarray(inputs.cameras[0].R),
                     t=jnp.asarray(inputs.cameras[0].t))
    n_cam = geo.normal_world_to_cam(cam, jnp.asarray(sc.gt_normals[0]))
    px, py = geo.pixel_grid(inputs.height, inputs.width)
    rng = np.random.default_rng(noise_seed)
    depth = sc.gt_depths[0] * rng.uniform(0.97, 1.03, sc.gt_depths[0].shape)
    return np.asarray(geo.plane_from_depth_normal(
        cam, px, py, jnp.asarray(depth.astype(np.float32)), n_cam))


def test_build_rect_host_copy_is_exact(scene):
    sc, inputs, data, rh, views, tdata = scene
    ours = trc.build_rect_host(inputs.cameras, inputs.width, inputs.height,
                               3)
    assert tuple(ours.statics) == tuple(rh.statics)[:4]
    for a, b in zip(ours.pairs, rh.pairs):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    for name in ("fwd", "bwd", "sfwd"):
        for a, b in zip(getattr(ours, name), getattr(rh, name)):
            for fa, fb in zip(a, b):
                np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    # _src_warp_fields alone, and a forced common frame.
    p = rh.pairs[1]
    for fa, fb in zip(trc._src_warp_fields(p, 80, 64),
                      rectcost._src_warp_fields(p, 80, 64)):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    fs = (rh.statics.wp + 128, rh.statics.hp + 8)
    a = trc.build_rect_host(inputs.cameras, 80, 64, 3, force_size=fs)
    b = rectcost.build_rect_host(inputs.cameras, 80, 64, 3, force_size=fs)
    assert (a.statics.wp, a.statics.hp) == fs
    for fa, fb in zip(a.fwd[0], b.fwd[0]):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_build_rect_views(scene):
    sc, inputs, data, rh, views, tdata = scene
    ours = trc.build_rect_views(trc.build_rect_host(
        inputs.cameras, inputs.width, inputs.height, 3), inputs.images, "cpu")
    for rv, tv in zip(views, ours):
        np.testing.assert_allclose(tv.ref_rect.numpy(),
                                   np.asarray(rv.ref_rect), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(tv.src_rect.numpy(),
                                   np.asarray(rv.src_rect), rtol=1e-5,
                                   atol=1e-4)
        for name in ("ref_ok", "src_ok", "orig_ok", "f_vy", "b_hx", "H_ref",
                     "R2r", "f", "cx", "b"):
            np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                          np.asarray(getattr(rv, name)))
    plane = _gt_plane(sc, inputs)
    np.testing.assert_allclose(
        trc.plane_to_rect(torch.tensor(plane), ours[0].R2r).numpy(),
        np.asarray(rectcost.plane_to_rect(jnp.asarray(plane),
                                          views[0].R2r)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_rect_cost_vector_stacked(scene, stride):
    sc, inputs, data, rh, views, tdata = scene
    params = schedule_params(PatchMatchParams(), 0, None)
    offs = pm.strong_offsets(params)
    plane = _gt_plane(sc, inputs)

    def jax_costs(vs, pl):
        stack = rectcost.build_rect_stack(vs, rh.statics)
        cache = (rectcost.build_eval_cache(stack, params, offs, stride=stride)
                 if stride > 1 else None)
        return rectcost.rect_cost_vector_stacked(
            stack, pl, data.view_valid, params, offs, stride=stride,
            cache=cache)

    ref = np.asarray(jax.jit(jax_costs)(views, jnp.asarray(plane)))
    stack = rectcost.build_rect_stack(views, rh.statics)

    statics = torch_parity.port_statics(rh.statics)
    tstack = trc.build_rect_stack(tdata.rect, statics)
    tparams = torch_parity.port_params(params)
    tcache = (trc.build_eval_cache(tstack, tparams, offs, stride=stride)
              if stride > 1 else None)
    out = trc.rect_cost_vector_stacked(
        tstack, torch.tensor(plane), tdata.view_valid, tparams, offs,
        stride=stride, cache=tcache).numpy()
    assert out.shape == ref.shape == (3, 64, 80)
    good = ref < 0.5
    assert good.mean() > 0.3 and (ref >= 2.0).mean() > 0.01
    torch_parity.assert_costs_close(out, ref)
    for name in ("src_lo", "src_hi"):
        np.testing.assert_array_equal(getattr(tstack, name).numpy(),
                                      np.asarray(getattr(stack, name)))


@pytest.mark.parametrize("stride", [1, 2])
def test_rect_disparity_sweep(scene, stride):
    sc, inputs, data, rh, views, tdata = scene
    params = schedule_params(PatchMatchParams(), 0, None)
    H, W = inputs.height, inputs.width
    rng = np.random.default_rng(stride)
    plane = np.concatenate([sc.gt_normals[0], sc.gt_depths[0][..., None]],
                           axis=-1).astype(np.float32)   # (n_world, depth)
    selected = rng.integers(0, 8, (H, W)).astype(np.uint32)
    view_weight = rng.integers(0, 5, (H, W, 3)).astype(np.int32)
    st = st_mod.PMState(plane=jnp.asarray(plane),
                        cost=jnp.zeros((H, W), jnp.float32),
                        selected=jnp.asarray(selected),
                        view_weight=jnp.asarray(view_weight),
                        weak=jnp.ones((H, W), jnp.uint8),
                        key=jax.random.key(0))
    disps = np.arange(-5, 6, dtype=np.float32)
    data_r = data._replace(rect=views)
    ref = np.asarray(jax.jit(
        lambda d, s: weak_rect.rect_disparity_sweep(
            d, s, params, rh.statics, disps, stride=stride))(data_r, st))

    tstate = tst.pm_state_from_numpy(torch_parity.to_numpy(st), None, "cpu")
    out = twr.rect_disparity_sweep(tdata, tstate,
                                   torch_parity.port_params(params),
                                   torch_parity.port_statics(rh.statics),
                                   disps, stride=stride).numpy()
    assert out.shape == ref.shape == (11, H, W)
    assert (ref < 1.0).mean() > 0.2
    torch_parity.assert_costs_close(out, ref)


def test_finish_classify_refine_stages(scene):
    sc, inputs, data, rh, views, tdata = scene
    params = schedule_params(PatchMatchParams(), 0, None)
    H, W = inputs.height, inputs.width
    rng = np.random.default_rng(7)
    st = st_mod.PMState(
        plane=jnp.asarray(_gt_plane(sc, inputs, noise_seed=3)),
        cost=jnp.asarray(rng.uniform(0, 0.6, (H, W)).astype(np.float32)),
        selected=jnp.asarray(rng.integers(1, 8, (H, W)).astype(np.uint32)),
        view_weight=jnp.asarray(rng.integers(0, 5, (H, W, 3))
                                .astype(np.int32)),
        weak=jnp.ones((H, W), jnp.uint8), key=jax.random.key(0))
    data_r = data._replace(rect=views)
    statics = torch_parity.port_statics(rh.statics)
    tparams = torch_parity.port_params(params)

    fin = stages._finish_j(data_r, st, params)
    tst0 = tst.pm_state_from_numpy(torch_parity.to_numpy(st), None, "cpu")
    tfin = tstages._finish_stage(tdata, tst0, tparams)
    np.testing.assert_allclose(tfin.plane.numpy(), np.asarray(fin.plane),
                               rtol=1e-5, atol=1e-5)

    # Classify and refine from the JAX finish state.
    tfin = tst.pm_state_from_numpy(torch_parity.to_numpy(fin), None, "cpu")
    cls = stages._classify_j(data_r, fin, params, rh.statics)
    tcls = tstages._classify_stage(tdata, tfin, tparams, statics)
    weak_j = np.asarray(cls.weak)
    assert len(np.unique(weak_j)) == 3          # weak, strong and unknown
    assert (tcls.weak.numpy() == weak_j).mean() >= 0.98

    # Refine from depths pushed off by up to 15%, so that it has work.
    noisy = np.asarray(cls.plane).copy()
    noisy[..., 3] *= rng.uniform(0.85, 1.15, (H, W)).astype(np.float32)
    cls = cls._replace(plane=jnp.asarray(noisy))
    ref = np.asarray(stages._refine_j(data_r, cls, params,
                                      rh.statics).plane)[..., 3]
    tcls = tst.pm_state_from_numpy(torch_parity.to_numpy(cls), None, "cpu")
    out = tstages._refine_stage(tdata, tcls, tparams, statics).plane[..., 3]
    moved = ref != noisy[..., 3]
    assert moved.mean() > 0.05
    assert np.isclose(out.numpy(), ref, rtol=1e-4, atol=0).mean() >= 0.98


def test_static_warps_equal_jax_stacked_warps(tmp_path):
    """The pipeline's static warps in a round's common rect frame
    (``pipeline/schedule._rect_host``) against the JAX pipeline's stacked
    warps there (square-padded fields with runtime transpose flags), for two
    problems of one round: every warped image, mask and source-depth field
    and the backward warps, bit for bit against JAX run op by op. (Compiled
    JAX contracts the bilinear lerps into FMAs: images within the rtol 1e-5
    of ``test_build_rect_views``.)"""
    from dpe_mvs_tpu_torch.io import scene as tscene
    from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
    from dpe_mvs_tpu_torch.utils import synthetic as tsynth
    sc = tsynth.make_plane_scene(width=64, height=48, num_views=4, seed=4)
    folder = tsynth.write_scene_folder(sc, tmp_path / "s")
    problems = tscene.generate_sample_list(folder)
    v_pad = 3
    frame = tschedule.round_rect_frame(problems, 1, v_pad)
    rng = np.random.default_rng(0)
    flags = set()
    for p in problems[:2]:
        inp = tscene.load_problem_inputs(p, 1, need_prior=False,
                                         need_weak=False,
                                         need_src_depths=False)
        deps = np.stack([sc.gt_depths[i] for i in p.src_image_ids]) * \
            rng.uniform(0.9, 1.1, (v_pad, 48, 64)).astype(np.float32)
        trh = tschedule._rect_host(p, inp, v_pad, frame)
        ours = trc.build_rect_views(trh, inp.images, "cpu", src_depths=deps,
                                    cameras=inp.cameras)
        jrh = rectcost.build_rect_host(inp.cameras, 64, 48, v_pad,
                                       force_size=frame, stacked=True)
        with jax.disable_jit():
            theirs = rectcost.build_rect_views(jrh, inp.images, deps,
                                               cameras=inp.cameras)
        compiled = rectcost.build_rect_views(jrh, inp.images, deps,
                                             cameras=inp.cameras)
        assert (trh.statics.wp, trh.statics.hp) == frame
        flags |= set(trh.statics.f_transposed + trh.statics.b_transposed)
        field = rng.random((frame[1], frame[0])).astype(np.float32)
        chans = rng.random((2, 48, 64)).astype(np.float32)
        for i, (a, b, c) in enumerate(zip(ours, theirs, compiled)):
            for name in ("ref_rect", "src_rect", "ref_ok", "src_ok",
                         "src_depth_rect", "orig_ok"):
                np.testing.assert_array_equal(
                    getattr(a, name).numpy(), np.asarray(getattr(b, name)),
                    err_msg=f"{p.ref_image_id} {i} {name}")
            np.testing.assert_allclose(a.ref_rect.numpy(),
                                       np.asarray(c.ref_rect), rtol=1e-5,
                                       atol=1e-4)
            for nearest in (True, False):
                x = trc.warp_bwd(a, trh.statics, i, torch.tensor(field),
                                 nearest=nearest)
                y = trc.warp_fwd_channels(a, trh.statics, i,
                                          torch.tensor(chans),
                                          nearest=nearest)
                with jax.disable_jit():
                    xj = rectcost.warp_bwd(b, jrh.statics, i,
                                           jnp.asarray(field),
                                           nearest=nearest)
                    yj = rectcost.warp_fwd_channels(b, jrh.statics, i,
                                                    jnp.asarray(chans),
                                                    nearest=nearest)
                np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
                np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    assert flags == {False, True}        # both warp orientations ran
