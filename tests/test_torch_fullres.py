"""The PyTorch port's full-resolution branches, forced on small frames.

  * Row-banded ``rect_cost_vector_stacked`` (``BAND_FULL_BYTES`` forced to
    0, a ``BAND_FIELD_BYTES`` that gives >= 3 bands with a ragged last band)
    equals the unbanded evaluation bit for bit in four branches: (stride 1,
    no cache), (stride 1, geom), (stride 2, EvalCache) and (stride 2, no
    cache), the last being the branch of frames whose cache exceeds its
    budget. Every read is row-local in the rect frame, so banding changes
    only the slicing; the band's elementwise work is the same per element.
  * The port's banded evaluation against the JAX package's banded one (both
    gates forced): ``torch_parity.assert_costs_close``, the tolerance of
    ``test_torch_rectcost.py::test_rect_cost_vector_stacked``.
  * The scanned view-selection draws (``patchmatch.FULLRES_PX``): above the
    gate the port draws the JAX package's numbers through
    ``torch_parity.JaxKey`` and selects the same views with the same
    weights, exactly (integer and PRNG work), at the smallest frame over
    4 MP that the JAX package's literal gate lets it take (2 views,
    2000x2001); and with the port's gate forced low on a small frame,
    against the JAX scan's code written out here.
  * bf16 screening: one strong iteration with ``FULLRES_PX`` forced low
    against the port's own float32 screening (see the test's docstring for
    its agreement share).
  * ``tools/torch_probe.py --cpu`` at a tiny frame exits 0, at round 0 and
    at round 1 (``--round 1``).

The scene is ``tests/test_torch_rectcost.py``'s (80x64, 3 source views),
built once per module.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity
from dpe_mvs_tpu_torch.engine import patchmatch as tpm
from dpe_mvs_tpu_torch.engine import rectcost as trc
from dpe_mvs_tpu_torch.geometry import rectify as trectify
from dpe_mvs_tpu_torch.utils.profiling import BRANCHES

import jax
import jax.numpy as jnp
from dpe_mvs_tpu.config import PatchMatchParams, schedule_params
from dpe_mvs_tpu.engine import patchmatch as pm
from dpe_mvs_tpu.engine import rectcost
from dpe_mvs_tpu.engine import state as st_mod
from dpe_mvs_tpu.geometry import cameras as geo
from dpe_mvs_tpu.geometry import rectify
from dpe_mvs_tpu.io import scene as scene_mod
from dpe_mvs_tpu.utils.synthetic import make_plane_scene

ROOT = Path(__file__).resolve().parents[1]
V_PAD = 3
BANDS = [(1, False, False), (1, True, False), (2, False, True),
         (2, False, False)]            # (stride, geom, cache)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    torch.set_num_threads(1)
    folder = tmp_path_factory.mktemp("torch_fullres_scene")
    sc = make_plane_scene(folder, width=80, height=64, num_views=4, seed=5)
    problems = scene_mod.generate_sample_list(sc.folder)
    inputs = scene_mod.load_problem_inputs(
        problems[0], 1, need_prior=False, need_weak=False,
        need_src_depths=False)
    data = st_mod.build_sweep_data(inputs, V_PAD)
    rh = rectcost.build_rect_host(inputs.cameras, inputs.width,
                                  inputs.height, V_PAD)
    src_depths = np.stack([sc.gt_depths[i + 1] for i in range(V_PAD)])
    views = rectcost.build_rect_views(rh, inputs.images, src_depths,
                                      cameras=inputs.cameras)
    tdata = torch_parity.port_inputs(data, views)
    tstack = trc.build_rect_stack(tdata.rect,
                                  torch_parity.port_statics(rh.statics))

    cam = geo.Camera(K=jnp.asarray(inputs.cameras[0].K),
                     R=jnp.asarray(inputs.cameras[0].R),
                     t=jnp.asarray(inputs.cameras[0].t))
    n_cam = geo.normal_world_to_cam(cam, jnp.asarray(sc.gt_normals[0]))
    px, py = geo.pixel_grid(inputs.height, inputs.width)
    rng = np.random.default_rng(0)
    depth = sc.gt_depths[0] * rng.uniform(0.97, 1.03, sc.gt_depths[0].shape)
    plane = np.asarray(geo.plane_from_depth_normal(
        cam, px, py, jnp.asarray(depth.astype(np.float32)), n_cam))
    params = schedule_params(PatchMatchParams(), 0, None)
    return dict(inputs=inputs, data=data, rh=rh, views=views, tdata=tdata,
                tstack=tstack, statics=torch_parity.port_statics(rh.statics),
                plane=plane, params=params,
                tparams=torch_parity.port_params(params),
                offs=pm.strong_offsets(params))


def _band_bytes(V, Hs, Ws, hb):
    """A BAND_FIELD_BYTES that makes band_rows pick band height hb."""
    return 4 * V * Ws * hb


def _force_bands(monkeypatch, module, V, Hs, Ws):
    """Force banding into >= 3 bands with a ragged last band; returns the
    band height."""
    hb = 16 if Hs % 16 else 24
    assert -(-Hs // hb) >= 3 and Hs % hb
    monkeypatch.setattr(module, "BAND_FULL_BYTES", 0)
    monkeypatch.setattr(module, "BAND_FIELD_BYTES",
                        _band_bytes(V, Hs, Ws, hb))
    return hb


def _port_costs(s, stride, geom, cache):
    c = (trc.build_eval_cache(s["tstack"], s["tparams"], s["offs"],
                              stride=stride, geom=geom) if cache else None)
    return trc.rect_cost_vector_stacked(
        s["tstack"], torch.tensor(s["plane"]), s["tdata"].view_valid,
        s["tparams"], s["offs"], geom=geom, stride=stride, cache=c)


def test_band_rows():
    """The JAX package's band sizes: one band up to BAND_FULL_BYTES, then
    bands of BAND_FIELD_BYTES per field in multiples of 8 rows, >= 8."""
    assert trc.band_rows(5, 960, 1024) == (960, 1)
    # 3200x2400's stride-1 field: 5 x 3840 x 4096 words.
    hb, nb = trc.band_rows(5, 3840, 4096)
    assert (hb, nb) == (584, 7) and hb * 5 * 4096 * 4 <= trc.BAND_FIELD_BYTES
    assert trc.band_rows(5, 100, 10**7) == (8, 13)
    assert trc.band_rows(1, 8, 3 * 10**7) == (8, 1)


@pytest.mark.parametrize("stride,geom,cache", BANDS)
def test_banded_equals_unbanded(scene, monkeypatch, stride, geom, cache):
    """Banded == unbanded, bit for bit, in every branch."""
    s = scene
    V, Hp, Wp = s["tstack"].src_rect.shape
    Hs, Ws = -(-Hp // stride), -(-Wp // stride)
    ref = _port_costs(s, stride, geom, cache)
    assert trc.band_rows(V, Hs, Ws)[1] == 1
    hb = _force_bands(monkeypatch, trc, V, Hs, Ws)
    assert trc.band_rows(V, Hs, Ws) == (hb, -(-Hs // hb))
    # One offset per bilinear_x launch too: the launch bound splits rows.
    monkeypatch.setattr(trc, "GATHER_BYTES", 1)
    calls = []
    orig = trc.rowgather.bilinear_x
    monkeypatch.setattr(trc.rowgather, "bilinear_x",
                        lambda img, x: calls.append(x.shape) or orig(img, x))
    BRANCHES.clear()
    out = _port_costs(s, stride, geom, cache)
    nb = -(-Hs // hb)
    assert BRANCHES == {"banded cost evaluations": 1, "cost bands": nb}
    assert all(c == (V * hb, Ws) for c in calls)
    assert len(calls) == nb * len(s["offs"])
    good = ref < 0.5
    assert good.float().mean() > 0.2
    assert torch.equal(out, ref)


@pytest.mark.parametrize("stride,geom,cache", BANDS)
def test_banded_matches_jax_banded(scene, monkeypatch, stride, geom, cache):
    """The port's bands against the JAX package's (both gates forced)."""
    s = scene
    V, Hp, Wp = s["tstack"].src_rect.shape
    Hs, Ws = -(-Hp // stride), -(-Wp // stride)
    _force_bands(monkeypatch, trc, V, Hs, Ws)
    _force_bands(monkeypatch, rectcost, V, Hs, Ws)
    out = _port_costs(s, stride, geom, cache).numpy()

    def jax_costs(vs, pl):
        stack = rectcost.build_rect_stack(vs, s["rh"].statics)
        c = (rectcost.build_eval_cache(stack, s["params"], s["offs"],
                                       stride=stride, geom=geom)
             if cache else None)
        return rectcost.rect_cost_vector_stacked(
            stack, pl, s["data"].view_valid, s["params"], s["offs"],
            geom=geom, stride=stride, cache=c)

    ref = np.asarray(jax.jit(jax_costs)(s["views"], jnp.asarray(s["plane"])))
    assert out.shape == ref.shape == (V_PAD, 64, 80)
    torch_parity.assert_costs_close(out, ref)


def _costs_for_selection(shape, seed):
    """(8, V, H, W) candidate costs in [0, 2] with ties at 0 (invalid
    candidates), a (V, H, W) prior and the (V,) valid views."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    c[rng.random(shape) < 0.1] = 0.0
    prior = rng.uniform(0.0, 1.0, shape[1:]).astype(np.float32)
    return c, prior, np.ones(shape[1], bool)


def _check_selection(out, ref):
    vw, sel, norm = out
    np.testing.assert_array_equal(vw.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(sel.numpy().view(np.uint32),
                                  np.asarray(ref[1]))
    np.testing.assert_array_equal(norm.numpy(), np.asarray(ref[2]))


def test_scanned_draws_equal_jax_above_4mp():
    """2 views at 2000x2001 (4 002 000 px): both packages take the scan, the
    port drawing through JaxKey."""
    H, W = 2000, 2001
    assert H * W > tpm.FULLRES_PX and H * W > 4_000_000
    BRANCHES.clear()
    c, prior, valid = _costs_for_selection((8, 2, H, W), 1)
    key = jax.random.key(17)
    ref = pm.view_selection(key, jnp.asarray(c), jnp.asarray(prior),
                            jnp.asarray(valid), 2)
    out = tpm.view_selection(torch_parity.JaxKey(key), torch.from_numpy(c),
                             torch.from_numpy(prior), torch.from_numpy(valid),
                             2)
    _check_selection(out, ref)
    assert BRANCHES["scanned draws"] >= 1
    hit = (out[0] > 0).flatten(1).float().mean(1)      # draws hit both views
    assert (hit > 0.3).all(), hit


def _jax_scanned_selection(key, cost_array, prior, valid_view, it):
    """The JAX package's view_selection with its > 4 MP branch taken at any
    size: ``dpe_mvs_tpu/engine/patchmatch.py:397-446`` with the gate
    removed (its code otherwise as it is there)."""
    nview = cost_array.shape[1]
    itf = jnp.asarray(it, jnp.float32)
    cost_threshold = 0.8 * jnp.exp(itf * itf / -90.0)
    good = cost_array < cost_threshold
    bad = cost_array > 1.2
    count = jnp.sum(good, axis=0).astype(jnp.float32)
    count_false = jnp.sum(bad, axis=0)
    tmpw = jnp.sum(jnp.where(good, jnp.exp(cost_array * cost_array / -0.18),
                             0.0), axis=0)
    probs = jnp.where(
        (count > 2) & (count_false < 3), tmpw / jnp.maximum(count, 1.0),
        jnp.where(count_false < 3,
                  jnp.exp(cost_threshold * cost_threshold / -0.32), 0.0))
    probs = probs * prior * valid_view[:, None, None]
    psum = jnp.sum(probs, axis=0, keepdims=True)
    cdf = jnp.cumsum(probs, axis=0) / jnp.maximum(psum, 1e-30)
    cdf = jnp.where(psum > 0, cdf, 0.0)
    H, W = cost_array.shape[2:]

    def draw(acc, key_i):
        ui = jax.random.uniform(key_i, (H, W))
        hits = cdf > ui[None]
        first = jnp.argmax(hits, axis=0)
        any_hit = jnp.any(hits, axis=0)
        one_hot = (first[None] == jnp.arange(nview)[:, None, None]) \
            & any_hit[None]
        return acc + one_hot.astype(jnp.int32), None

    view_weight, _ = jax.lax.scan(
        draw, jnp.zeros((nview, H, W), jnp.int32), jax.random.split(key, 15))
    w_pos = view_weight > 0
    selected = jnp.sum(
        w_pos.astype(jnp.uint32)
        << jnp.arange(nview, dtype=jnp.uint32)[:, None, None], axis=0)
    weight_norm = jnp.sum(view_weight, axis=0).astype(jnp.float32)
    return view_weight, selected, weight_norm


@pytest.mark.parametrize("nview", [3, 5])
def test_scanned_draws_forced_equal_jax_scan(monkeypatch, nview):
    """The port's gate forced to 0 on a small frame, against the JAX scan's
    code; the port's unscanned branch draws other numbers there."""
    c, prior, valid = _costs_for_selection((8, nview, 37, 29), nview)
    valid[-1] = nview == 3
    key = jax.random.key(5 + nview)
    ref = _jax_scanned_selection(key, jnp.asarray(c), jnp.asarray(prior),
                                 jnp.asarray(valid), 1)
    args = (torch.from_numpy(c), torch.from_numpy(prior),
            torch.from_numpy(valid), 1)
    unscanned = tpm.view_selection(torch_parity.JaxKey(key), *args)
    assert not torch.equal(unscanned[0], torch.from_numpy(np.array(ref[0])))
    monkeypatch.setattr(tpm, "FULLRES_PX", 0)
    _check_selection(tpm.view_selection(torch_parity.JaxKey(key), *args),
                     ref)


def test_bf16_screening_agrees_with_f32(scene, monkeypatch):
    """One strong iteration (stride-2 screening, both colors) with the
    screening volumes stored as bf16 (``FULLRES_PX`` forced to 0) against
    the float32 screening, from the same state and key; the view-selection
    draws keep the unscanned branch in both runs, so only the cast differs.

    bf16 keeps 8 bits of a cost in [0, 2]: screening costs move by up to
    2^-8 relative, which reorders near-tied candidates and shifts the
    good/bad view counts at their thresholds (and so the view weights of
    a few pixels' draws). The winner is re-scored exactly in float32. On
    this scene 99.59% of the planes are bit-equal and 99.90% of the costs
    within 0.05 of the float32 run's; held to >= 99% and >= 99.5%."""
    from dpe_mvs_tpu_torch.engine import stages as tstages
    from dpe_mvs_tpu_torch.engine import state as tst
    from dpe_mvs_tpu_torch.engine import strong_rect as tsr
    from dpe_mvs_tpu_torch.utils.rng import TorchKey

    s = scene
    params = s["tparams"].replace(propagate_stride=2)
    st0 = st_mod.init_pm_state(s["inputs"], V_PAD, jax.random.key(3), False)
    ts0 = tst.pm_state_from_numpy(torch_parity.to_numpy(st0), TorchKey(3),
                                  "cpu")
    ts1 = tsr.initialize_rect(s["tdata"], ts0, params, s["statics"])

    def iteration():
        return tstages._strong_iter(s["tdata"], ts1, 0, TorchKey(7), params,
                                    s["statics"])

    f32 = iteration()
    dtypes = []
    orig = tpm.view_selection

    def unscanned(key, cost_array, *a):
        dtypes.append(cost_array.dtype)
        monkeypatch.setattr(tpm, "FULLRES_PX", 4_000_000)
        try:
            return orig(key, cost_array, *a)
        finally:
            monkeypatch.setattr(tpm, "FULLRES_PX", 0)

    monkeypatch.setattr(tpm, "view_selection", unscanned)
    monkeypatch.setattr(tpm, "FULLRES_PX", 0)
    BRANCHES.clear()
    bf16 = iteration()
    assert dtypes == [torch.bfloat16] * 2
    assert BRANCHES == {"bf16 screening": 2}
    same = (bf16.plane == f32.plane).all(-1)
    moved = ~(f32.plane == ts1.plane).all(-1)
    assert moved.float().mean() > 0.2                 # the iteration worked
    assert same.float().mean() >= 0.99, same.float().mean()
    near = (bf16.cost - f32.cost).abs() <= 0.05
    assert near.float().mean() >= 0.995, near.float().mean()


def test_warp_fields_on_torch_equal_jax_numpy(scene):
    """The rect host's per-pixel fields, evaluated with torch (the CPU here,
    the card in a sweep), equal the JAX package's numpy fields bit for bit:
    every warp field of the scene's pairs, a transposed warp of a larger
    frame, and the source-depth factor (the JAX expression,
    ``dpe_mvs_tpu/engine/rectcost.py:315-324``)."""
    rh = scene["rh"]
    inputs = scene["inputs"]
    W, H = inputs.width, inputs.height
    for pair, cam in zip(rh.pairs, inputs.cameras[1:]):
        for args in ((pair.H_ref, W, H, rh.statics.wp, rh.statics.hp),
                     (np.linalg.inv(pair.H_ref), rh.statics.wp,
                      rh.statics.hp, W, H),
                     (pair.H_src, W, H, pair.width, pair.height)):
            ours = trectify.build_warp_fields(*args, device="cpu")
            ref = rectify.build_warp_fields(*args)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        xg, yg = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        Ks = np.asarray(cam.K, np.float64)
        p_s = np.stack([(xg - Ks[0, 2]) / Ks[0, 0],
                        (yg - Ks[1, 2]) / Ks[1, 1], np.ones_like(xg)])
        r3 = pair.R2s[2]
        factor = (r3[0] * p_s[0] + r3[1] * p_s[1] + r3[2] * p_s[2]) \
            .astype(np.float32)
        np.testing.assert_array_equal(
            trectify.src_depth_factor(pair, cam.K, W, H).numpy(), factor)
    rot = np.array([[0.1, 0.95, 3.0], [-0.97, 0.12, 900.0], [1e-5, 2e-5, 1]])
    assert trectify._needs_transpose(rot)
    for a, b in zip(trectify.build_warp_fields(rot, 1003, 701, 1280, 1088),
                    rectify.build_warp_fields(rot, 1003, 701, 1280, 1088)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_probe_runs_on_the_cpu():
    """``tools/torch_probe.py --cpu`` at a tiny frame: FIRST_INIT, then the
    modal sweep from its writeback with mid-depth source maps, the rect
    cost field banded through the probe's own arguments; then with
    ``--round 1`` round 1's REFINE_INIT from the half-size ground truth and
    its modal sweep, the disparity sweeps chunked and the anchor search
    banded through the probe's arguments."""
    import json
    import os

    def probe(*args):
        res = subprocess.run(
            [sys.executable, "tools/torch_probe.py", "32", "24", "3", "apd",
             "geom", "--cpu", *args], cwd=ROOT, capture_output=True,
            text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert res.returncode == 0, res.stdout + res.stderr
        return json.loads(res.stdout.strip().splitlines()[-1])["probe"]

    rec = probe("--band-full-bytes", "0", "--band-field-bytes", "30000")
    assert [s["sweep"] for s in rec["sweeps"]] == ["FIRST_INIT",
                                                   "modal REFINE_ITER"]
    assert rec["band_full_bytes"] == 0
    for sw in rec["sweeps"]:
        assert sw["branches"]["cost bands"] > sw["branches"][
            "banded cost evaluations"] > 0
        assert {"rectify", "strong", "writeback"} <= set(sw["spans"])
    assert "weak" in rec["sweeps"][1]["spans"]
    assert rec["valid"] > 0.5

    rec = probe("--round", "1", "--sweep-chunk-bytes", "20000",
                "--anchor-band-bytes", "100000")
    assert rec["round"] == 1
    assert [s["sweep"] for s in rec["sweeps"]] == [
        "round 1 REFINE_INIT", "round 1 modal REFINE_ITER"]
    for sw in rec["sweeps"]:
        assert {"support", "weakprep", "weak", "classify"} <= set(sw["spans"])
        for name in ("disparity-sweep chunks", "classify bands",
                     "anchor-search bands"):
            assert sw["branches"][name] > 1, (name, sw["branches"])
    assert rec["median_rel_err"] < 0.02 and rec["valid"] > 0.5
