"""Fusion, the PLY format, colour image I/O and the debug images of the
PyTorch port against the JAX package (and OpenCV) on the CPU.

  * ``run_fusion`` on one dense folder, with ``.dmb`` state written from a
    scene's ground truth (some depths perturbed or zeroed so that the vote
    rejects them, random weak labels, colour images, one sky mask), at the
    images' size and at half of it (the colour-resize branch of
    ``_ViewCache`` and the sky-mask resize): the same points, colours and
    count as JAX ``run_fusion`` run op by op (``jax.disable_jit``), bit for
    bit. Against the compiled JAX function the colours and count are equal
    and the points agree to 1e-6, relative and absolute: XLA:CPU contracts
    the back-projection's multiply-adds into FMAs, which moves a coordinate
    (of size 0 to 5 in these scenes; an ulp at 4 is 4.8e-7) by an ulp or
    two of its operands.
  * ``_fuse_view`` on random inputs, among them NaN depths, projections
    beyond the int32 range (points on a source's principal plane) and a
    source that looks away from the scene: every output equal to the JAX
    function's, op by op.
  * ``export_depth_image_point_cloud``, ``write_ply`` / ``read_ply`` (each
    package reads the other's file).
  * ``imread.read_color_u8`` equals ``cv2.imread(IMREAD_COLOR)`` on gray, RGB
    and RGBA PNG, PPM, PGM and colour and gray JPEG at ragged sizes; the
    Pillow JPEG writer's files decode to the pixels of ``cv2.imencode``'s;
    ``read_gray_u8`` still equals ``IMREAD_GRAYSCALE`` on the same files.
  * ``utils.viz``: the four maps' arrays equal those the JAX package hands
    ``cv2.imwrite``; the pipeline's ``rawedge`` and ``connect`` images equal
    JAX ``get_problem_edges``' for the same edge and label arrays.

GPU (marked ``gpu``, skipped without a CUDA device): ``run_fusion`` on the
card equals it on the CPU, points and colours, at both state sizes.
"""
import shutil

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch.config import PatchMatchParams as TParams
from dpe_mvs_tpu_torch.geometry import cameras as tgeo
from dpe_mvs_tpu_torch.io import formats as tformats
from dpe_mvs_tpu_torch.io import imread
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.pipeline import fusion as tfusion
from dpe_mvs_tpu_torch.pipeline import schedule as tschedule
from dpe_mvs_tpu_torch.utils import synthetic as tsynth
from dpe_mvs_tpu_torch.utils import viz as tviz

W, H, VIEWS, SEED = 64, 48, 4, 3
POINT_TOL = 1e-6            # against compiled JAX (FMA contraction)


def _write_state(folder, sc_state, rng):
    """``.dmb`` state from ``sc_state``'s ground truth: depths with 10%
    perturbed by up to 10% and 5% zeroed, camera-frame normals, random weak
    labels."""
    for v, (d0, n0, cam) in enumerate(zip(sc_state.gt_depths,
                                          sc_state.gt_normals,
                                          sc_state.cameras)):
        rf = tformats.result_folder(folder, v)
        rf.mkdir(parents=True, exist_ok=True)
        d = d0.copy()
        bad = rng.random(d.shape) < 0.1
        d[bad] *= rng.uniform(0.9, 1.1, int(bad.sum())).astype(np.float32)
        d[rng.random(d.shape) < 0.05] = 0.0
        tformats.write_dmb(rf / "depths.dmb", d.astype(np.float32))
        tformats.write_dmb(rf / "normals.dmb",
                           (n0 @ cam.R.T).astype(np.float32))
        tformats.write_dmb(rf / "weak.bin",
                           rng.integers(0, 3, d.shape).astype(np.uint8))


def _state_folder(root, scale):
    """A dense folder of colour images at W x H and state at 1/scale of
    that size (rendered at that size, so the cameras scale exactly)."""
    sc = tsynth.make_plane_scene(width=W, height=H, num_views=VIEWS,
                                 seed=SEED)
    folder = tsynth.write_scene_folder(sc, root)
    rng = np.random.default_rng(scale)
    for v in range(VIEWS):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        imread.write_png_color(folder / "images" / f"{v:08d}.jpg", img)
    state = sc if scale == 1 else tsynth.make_plane_scene(
        width=W // scale, height=H // scale, num_views=VIEWS, seed=SEED)
    _write_state(folder, state, rng)
    (folder / "blocks").mkdir()
    sky = np.full((H, W), 255, np.uint8)
    sky[:13, :21] = 0
    imread.write_png_gray(folder / "blocks" / "mask_1.jpg", sky)
    return folder


@pytest.fixture(scope="module", params=[1, 2], ids=["full", "half"])
def fused(request, tmp_path_factory):
    import jax
    from dpe_mvs_tpu.io import formats as jformats
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import fusion as jfusion
    root = tmp_path_factory.mktemp(f"torch_fusion_{request.param}")
    folder = _state_folder(root / "port", request.param)
    copies = {k: root / k for k in ("op_by_op", "compiled")}
    for c in copies.values():
        shutil.copytree(folder, c)
    tfusion.run_fusion(folder, tscene.generate_sample_list(folder),
                       device="cpu")
    with jax.disable_jit():
        jfusion.run_fusion(copies["op_by_op"], jscene.generate_sample_list(
            copies["op_by_op"]))
    jfusion.run_fusion(copies["compiled"], jscene.generate_sample_list(
        copies["compiled"]))
    ply = "DPE/DPE.ply"
    return (folder, tformats.read_ply(folder / ply),
            {k: jformats.read_ply(c / ply) for k, c in copies.items()})


def test_run_fusion_equals_jax_op_by_op(fused):
    folder, (pts, cols), ref = fused
    rpts, rcols = ref["op_by_op"]
    assert pts.dtype == np.float32 and cols.dtype == np.uint8
    np.testing.assert_array_equal(pts, rpts)
    np.testing.assert_array_equal(cols, rcols)
    # The state makes the vote do work: points from every view, far fewer
    # than the valid depths (perturbed pixels, masks and the sky rejected).
    n_valid = sum(int((tformats.read_dmb(tformats.result_folder(folder, v)
                                         / "depths.dmb") > 0).sum())
                  for v in range(VIEWS))
    assert 100 < pts.shape[0] < 0.9 * n_valid, (pts.shape, n_valid)


def test_run_fusion_against_compiled_jax(fused):
    _, (pts, cols), ref = fused
    rpts, rcols = ref["compiled"]
    assert pts.shape == rpts.shape
    np.testing.assert_array_equal(cols, rcols)
    np.testing.assert_allclose(pts, rpts, rtol=POINT_TOL, atol=POINT_TOL)


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA device")
def test_gpu_run_fusion_equals_cpu(tmp_path):
    """Fusion on the card (its gathers through the ``gather2d_hwc`` kernel)
    gives the CPU's cloud, at both state sizes."""
    from dpe_mvs_tpu_torch.ops import gather2d as tg
    for scale in (1, 2):
        folder = _state_folder(tmp_path / f"card{scale}", scale)
        cpu = tmp_path / f"cpu{scale}"
        shutil.copytree(folder, cpu)
        tg.reset_launches()
        tfusion.run_fusion(folder, tscene.generate_sample_list(folder),
                           device="cuda")
        assert tg.LAUNCHES["gather2d_hwc"] == 3 * VIEWS * (VIEWS - 1)
        tfusion.run_fusion(cpu, tscene.generate_sample_list(cpu),
                           device="cpu")
        a = tformats.read_ply(folder / "DPE" / "DPE.ply")
        b = tformats.read_ply(cpu / "DPE" / "DPE.ply")
        assert a[0].shape[0] > 100
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _cams(sc, ids):
    return [sc.cameras[i] for i in ids]


@pytest.mark.parametrize("case", ["plain", "nan_and_far", "looking_away"])
def test_fuse_view_equals_jax(case):
    import jax
    import jax.numpy as jnp
    from dpe_mvs_tpu.pipeline import fusion as jfusion
    sc = tsynth.make_plane_scene(width=W, height=H, num_views=VIEWS,
                                 seed=SEED)
    rng = np.random.default_rng(["plain", "nan_and_far",
                                 "looking_away"].index(case))
    ref, srcs = sc.cameras[0], _cams(sc, [1, 2, 3])
    Ks = np.stack([c.K for c in srcs])
    Rs = np.stack([c.R for c in srcs])
    ts = np.stack([c.t for c in srcs])
    depth = (sc.gt_depths[0] * rng.uniform(0.995, 1.005, (H, W))
             ).astype(np.float32)
    if case == "nan_and_far":
        depth[rng.random((H, W)) < 0.05] = np.nan
        # Points on source 1's principal plane: its projection is far
        # beyond the int32 range (or infinite) there.
        ys, xs = rng.integers(0, H, 40), rng.integers(0, W, 40)
        C = -ref.R.T @ ref.t
        ray = np.stack([(xs - ref.K[0, 2]) / ref.K[0, 0],
                        (ys - ref.K[1, 2]) / ref.K[1, 1],
                        np.ones(40)], -1) @ ref.R
        r3, t3 = Rs[0][2].astype(np.float64), float(ts[0][2])
        depth[ys, xs] = -(r3 @ C + t3) / (ray @ r3)
    if case == "looking_away":
        flip = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
        Rs[1], ts[1] = flip @ Rs[1], flip @ ts[1]
    normal = (sc.gt_normals[0] @ ref.R.T + rng.normal(
        0, 0.05, (H, W, 3))).astype(np.float32)
    weak = rng.integers(0, 3, (H, W)).astype(np.uint8)
    ref_mask = rng.random((H, W)) < 0.05
    s_depths = np.stack([sc.gt_depths[i] for i in (1, 2, 3)]) * \
        rng.uniform(0.99, 1.01, (3, H, W)).astype(np.float32)
    s_normals = np.stack([sc.gt_normals[i] @ sc.cameras[i].R.T
                          for i in (1, 2, 3)]).astype(np.float32)
    s_masks = rng.random((3, H, W)) < 0.05
    tcam = tgeo.Camera(K=torch.tensor(ref.K), R=torch.tensor(ref.R),
                       t=torch.tensor(ref.t))
    tsrc = tgeo.Camera(K=torch.tensor(Ks), R=torch.tensor(Rs),
                       t=torch.tensor(ts))
    ours = tfusion._fuse_view(
        tcam, tsrc, torch.tensor(depth), torch.tensor(normal),
        torch.tensor(weak), torch.tensor(ref_mask), torch.tensor(s_depths),
        torch.tensor(s_normals), torch.tensor(s_masks))
    with jax.disable_jit():
        theirs = jfusion._fuse_view(
            (jnp.asarray(ref.K), jnp.asarray(ref.R), jnp.asarray(ref.t)),
            (jnp.asarray(Ks), jnp.asarray(Rs), jnp.asarray(ts)),
            jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(weak),
            jnp.asarray(ref_mask), jnp.asarray(s_depths),
            jnp.asarray(s_normals), jnp.asarray(s_masks))
    names = ("accept", "Xw", "num_consistent", "used", "used_x", "used_y")
    for name, a, b in zip(names, ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    accept, sxs = ours[0].numpy(), ours[4].numpy()
    assert 0 < accept.mean() < 0.95
    if case == "nan_and_far":
        assert (np.abs(sxs[0].astype(np.int64)) >= 2 ** 31 - 1).any()
        assert (sxs == 0).sum() > 0


def test_view_cache_resizes_colour_as_cv2(tmp_path):
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import fusion as jfusion
    folder = _state_folder(tmp_path / "s", 2)
    ours = tfusion._ViewCache(tscene.generate_sample_list(folder), 2)
    theirs = jfusion._ViewCache(jscene.generate_sample_list(folder), 2)
    for i in range(VIEWS):
        a, b = ours.get(i), theirs.get(i)
        assert a["img"].shape == (H // 2, W // 2, 3)
        for k in ("img", "depth", "normal", "weak"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("K", "R", "t"):
            np.testing.assert_array_equal(getattr(a["cam"], k),
                                          getattr(b["cam"], k))
        assert (a["cam"].width, a["cam"].height) == (W // 2, H // 2)
    assert len(ours._cache) == 2


@pytest.mark.parametrize("size", [(24, 32), (17, 29), (61, 7)])
def test_sky_mask_resize_matches_cv2(tmp_path, size):
    import cv2
    rng = np.random.default_rng(size[0])
    m = rng.integers(0, 256, (H, W), dtype=np.uint8)
    path = tmp_path / "mask_0.jpg"
    imread.write_png_gray(path, m)
    b = cv2.resize(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE),
                   (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tfusion._sky_mask(path, size[1], size[0]),
                                  b < 128)


def test_export_depth_image_point_cloud_equals_jax(tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import fusion as jfusion
    sc = tsynth.make_plane_scene(width=W, height=H, num_views=2, seed=SEED)
    cam = sc.cameras[1]
    rng = np.random.default_rng(5)
    depth = sc.gt_depths[1] * rng.uniform(0.8, 1.2, (H, W))
    depth = depth.astype(np.float32)
    depth[:3] = np.nan
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    jcam = jscene.CameraData(K=cam.K, R=cam.R, t=cam.t,
                             depth_min=cam.depth_min,
                             depth_max=cam.depth_max)
    lo, hi = float(np.nanmin(depth)) * 1.02, float(np.nanmax(depth)) * 0.98
    tfusion.export_depth_image_point_cloud(tmp_path / "a.ply", img, cam,
                                           depth, lo, hi)
    jfusion.export_depth_image_point_cloud(tmp_path / "b.ply", img, jcam,
                                           depth, lo, hi)
    a, b = tformats.read_ply(tmp_path / "a.ply"), \
        jformats.read_ply(tmp_path / "b.ply")
    assert 0 < a[0].shape[0] < H * W - 3 * W
    np.testing.assert_allclose(a[0], b[0], rtol=POINT_TOL, atol=POINT_TOL)
    np.testing.assert_array_equal(a[1], b[1])


def test_ply_round_trip_and_cross_read(tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1001, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (1001, 3), dtype=np.uint8)
    tformats.write_ply(tmp_path / "a.ply", pts, cols)
    jformats.write_ply(tmp_path / "b.ply", pts, cols)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    for read in (tformats.read_ply, jformats.read_ply):
        p, c = read(tmp_path / "a.ply")
        np.testing.assert_array_equal(p, pts)
        np.testing.assert_array_equal(c, cols)
    tformats.write_ply(tmp_path / "e.ply", np.zeros((0, 3)),
                       np.zeros((0, 3)))
    p, c = tformats.read_ply(tmp_path / "e.ply")
    assert p.shape == (0, 3) and c.shape == (0, 3)


SIZES = [(48, 64), (37, 53), (1, 7), (101, 3)]
KINDS = ["gray.png", "bgr.png", "bgra.png", "bgr.ppm", "gray.pgm",
         "bgr.jpg", "gray.jpg"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_read_color_matches_cv2(tmp_path, kind, size):
    import cv2
    rng = np.random.default_rng(size[0] * 100 + KINDS.index(kind))
    ch = {"gray": (), "bgr": (3,), "bgra": (4,)}[kind.split(".")[0]]
    img = rng.integers(0, 256, size + ch, dtype=np.uint8)
    path = str(tmp_path / f"img.{kind.split('.')[1]}")
    assert cv2.imwrite(path, img)
    ours = imread.read_color_u8(path)
    assert ours.dtype == np.uint8 and ours.shape == size + (3,)
    np.testing.assert_array_equal(ours, cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(imread.read_gray_u8(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_writer_matches_cv2(tmp_path, size):
    import cv2
    rng = np.random.default_rng(size[1])
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    imread.write_jpeg_color(tmp_path / "ours.jpg", img)
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    (tmp_path / "cv2.jpg").write_bytes(enc.tobytes())
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.jpg")),
                                  cv2.imdecode(enc, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(imread.read_color_u8(tmp_path / "cv2.jpg"),
                                  cv2.imdecode(enc, cv2.IMREAD_COLOR))
    imread.write_png_color(tmp_path / "ours.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours.png")),
                                  img)
    with pytest.raises(ValueError):
        imread.write_png_color(tmp_path / "bad.png", img[..., 0])


def _capture_imwrite(monkeypatch):
    import cv2
    written = {}

    def imwrite(path, img, *a):
        written[str(path).rsplit("/", 1)[-1]] = np.array(img)
        return True
    monkeypatch.setattr(cv2, "imwrite", imwrite)
    return written


def test_viz_arrays_equal_jax(tmp_path, monkeypatch):
    from dpe_mvs_tpu.utils import viz as jviz
    written = _capture_imwrite(monkeypatch)
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 6.0, (H, W)).astype(np.float32)
    depth[0, :5] = (np.nan, np.inf, 0.0, 0.99, 5.01)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    normal[1, :3] = 0.0
    weak = rng.integers(0, 3, (H, W)).astype(np.uint8)
    edge = (rng.random((H, W)) < 0.2).astype(np.uint8) * 255
    jviz.save_depth_map("d.jpg", depth, 1.0, 5.0)
    jviz.save_normal_map("n.jpg", normal)
    jviz.save_weak_map("w.jpg", weak)
    jviz.save_edge_map("e.jpg", edge)
    ours = {"d.jpg": tviz.depth_to_color(depth, 1.0, 5.0),
            "n.jpg": tviz.normal_to_color(normal),
            "w.jpg": tviz.weak_to_color(weak),
            "e.jpg": tviz.edge_to_color(edge)}
    for name, img in ours.items():
        assert img.dtype == np.uint8 and img.shape == (H, W, 3)
        np.testing.assert_array_equal(img, written[name], err_msg=name)
    # The writers store these arrays (PNG bytes under the given name).
    tviz.save_depth_map(tmp_path / "d.jpg", depth, 1.0, 5.0)
    tviz.save_normal_map(tmp_path / "n.jpg", normal)
    tviz.save_weak_map(tmp_path / "w.jpg", weak)
    tviz.save_edge_map(tmp_path / "e.jpg", edge)
    for name, img in ours.items():
        np.testing.assert_array_equal(imread.read_color_u8(tmp_path / name),
                                      img, err_msg=name)


def test_edge_debug_images_equal_jax(tmp_path, monkeypatch):
    """``rawedge_<s>.jpg`` and ``connect_<s>.jpg`` from the same edge and
    label arrays (the two packages' label ids agree only up to relabelling,
    so both are fed one array)."""
    from dpe_mvs_tpu.config import PatchMatchParams
    from dpe_mvs_tpu.edges import dual_level as jdual
    from dpe_mvs_tpu.io import scene as jscene
    from dpe_mvs_tpu.pipeline import schedule as jschedule
    from dpe_mvs_tpu_torch.edges import dual_level as tdual
    sc = tsynth.make_plane_scene(width=W, height=H, num_views=2, seed=SEED)
    folder = tsynth.write_scene_folder(sc, tmp_path / "s")
    rng = np.random.default_rng(2)
    edge = (rng.random((H // 2, W // 2)) < 0.1).astype(np.uint8) * 255
    label = rng.integers(-1, 40, (H, W)).astype(np.int32)
    for mod in (jdual, tdual):
        monkeypatch.setattr(mod, "fine_edges", lambda img, hr: edge)
        monkeypatch.setattr(mod, "coarse_labels", lambda img, s, hr: label)
    written = _capture_imwrite(monkeypatch)
    jp = jscene.generate_sample_list(folder, viz=True)[0]
    jschedule.get_problem_edges(jp, 2, PatchMatchParams())
    shutil.rmtree(folder / "DPE")
    tp = tscene.generate_sample_list(folder, viz=True)[0]
    tschedule.get_problem_edges(tp, 2, TParams())
    rf = tp.result_folder
    np.testing.assert_array_equal(imread.read_gray_u8(rf / "rawedge_1.jpg"),
                                  written["rawedge_1.jpg"])
    np.testing.assert_array_equal(imread.read_color_u8(rf / "connect_1.jpg"),
                                  written["connect_1.jpg"])
    np.testing.assert_array_equal(tviz.label_to_color(label),
                                  written["connect_1.jpg"])
