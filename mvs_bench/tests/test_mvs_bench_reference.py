"""The plain reference: its gathers against the program's plain versions,
the truth it works out against the rendered maps, and the matching cost."""
import numpy as np
import pytest
import torch

from dpe_mvs_tpu_torch.ops import gather2d as g2d
from dpe_mvs_tpu_torch.ops import rowgather
from mvs_bench import reference, scene


def _inputs(name, g):
    if name in ("row_gather", "bilinear_x"):
        img = torch.rand(5, 9, generator=g) * 255
        if name == "row_gather":
            idx = torch.randint(-3, 12, (5, 7), generator=g,
                                dtype=torch.int32)
        else:
            idx = torch.rand(5, 7, generator=g) * 14 - 2
        return (img, idx)
    iy = torch.randint(-2, 9, (3, 4), generator=g, dtype=torch.int32)
    ix = torch.randint(-2, 11, (3, 4), generator=g, dtype=torch.int32)
    if name == "gather2d":
        return (torch.rand(3, 6, 8, generator=g), iy, ix)
    if name == "gather2d_hwc":
        return (torch.rand(6, 8, 4, generator=g)[..., :3], iy, ix)
    ic = torch.randint(-1, 5, (3, 4), generator=g, dtype=torch.int64)
    return (torch.randint(0, 2 ** 30, (4, 6, 8), generator=g,
                          dtype=torch.int32), ic, iy, ix)


PLAIN = {"row_gather": rowgather.row_gather_ref,
         "bilinear_x": rowgather.bilinear_x_ref,
         "gather2d": g2d.gather2d_ref, "gather2d_hwc": g2d.gather2d_hwc_ref,
         "gather2d_pick": g2d.gather2d_pick_ref}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_kernel_reference_equals_plain_version(name):
    g = torch.Generator().manual_seed(4)
    args = _inputs(name, g)
    ref = reference.kernel_reference(name, args)
    assert reference.mismatches(PLAIN[name](*args), ref) == 0
    low = reference.kernel_reference(name, args, dtype=torch.bfloat16)
    if args[0].dtype == torch.float32:
        assert reference.mismatches(low, ref) > 0
    else:
        assert reference.mismatches(low, ref) == 0


def test_uint32_words_and_shape_mismatch():
    img = torch.randint(0, 2 ** 31 - 1, (2, 5), dtype=torch.int32)
    ix = torch.tensor([[0, 4, 9], [1, 1, -1]], dtype=torch.int32)
    ref = reference.kernel_reference("row_gather", (img.view(torch.uint32),
                                                    ix))
    assert ref.dtype == torch.uint32
    assert reference.mismatches(ref, ref.clone()) == 0
    assert reference.mismatches(ref[:1], ref) == ref.numel()


def test_truth_depth_matches_the_rendered_truth():
    sc = scene.make_plane_scene(width=64, height=48, num_views=3, seed=2)
    for v in range(3):
        for step in (1, 2):
            cam = reference.round_camera(sc.cameras[v], 64, 48, step)
            z = reference.truth_depth(sc.plane_normal, sc.plane_offset, cam,
                                      64 // step, 48 // step)
            gt = sc.gt_depths[v][::step, ::step]
            assert np.abs(z - gt).max() / gt.min() < 1e-5


def test_matching_cost_prefers_the_true_plane():
    sc = scene.make_plane_scene(width=96, height=72, num_views=4, seed=9)
    images = reference.images_at_round(sc, None, 1)
    cam = reference.round_camera(sc.cameras[0], 96, 72, 1)
    z = reference.truth_depth(sc.plane_normal, sc.plane_offset, cam, 96, 72)
    srcs = sc.src_ids(0)
    cams = [reference.round_camera(sc.cameras[s], 96, 72, 1) for s in srcs]
    rng = np.random.default_rng(0)
    px = rng.integers(20, 76, 200).astype(float)
    py = rng.integers(20, 52, 200).astype(float)
    d = z[py.astype(int), px.astype(int)]
    n = np.broadcast_to(cam.R @ sc.plane_normal, (200, 3))
    args = (images[0], [images[s] for s in srcs], cam, cams, px, py)
    c_true = reference.matching_cost(*args, d, n, 2)
    c_off = reference.matching_cost(*args, d * 1.05, n, 2)
    assert np.median(c_true) < 0.2
    assert np.median(c_off) > np.median(c_true) + 0.05


def test_judge():
    v = reference.judge({"a": 0.1, "b": 2.0, "c": float("nan")},
                        {"a": 0.2, "b": 1.0, "c": 1.0, "d": 0.0})
    assert [v[k]["ok"] for k in "abcd"] == [True, False, False, False]
