"""The PyTorch port's scene layer (``io/formats``, ``io/imread``,
``io/scene``) against the JAX package's ``io`` on the same files.

  * camera and pair files: each package reads what the other writes, with
    equal values (the DTU two-number depth line and a malformed file too);
  * ``read_gray`` equals ``cv2.imread(IMREAD_GRAYSCALE)`` (the JAX
    package's ``load_image_gray``) exactly, on a JAX ``make_plane_scene``
    folder (JPEG, through Pillow), a ``write_scene_folder`` folder (PNG
    bytes under ``.jpg`` names) and RGB / RGBA PNG, PGM and PPM files
    written by cv2;
  * ``jpeg_roundtrip_gray`` equals ``cv2.imdecode`` of ``cv2.imencode``
    (libjpeg's baseline codec) exactly, at ragged sizes, every kind of
    quality scaling and on flat, noisy and smooth images; bad arguments
    raise;
  * ``resize_linear`` against the JAX package's (``cv2.resize``): exact at
    halvings, within 1e-4 on [0, 255] images at ragged sizes;
  * ``generate_sample_list``, ``check_images`` and ``load_problem_inputs``
    (priors, weak map and source depths present) on the same folder:
    cameras and depth range exact, images within the resize tolerance.
"""
import shutil

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch.io import formats as tformats
from dpe_mvs_tpu_torch.io import imread
from dpe_mvs_tpu_torch.io import scene as tscene
from dpe_mvs_tpu_torch.utils import synthetic as tsynth

RESIZE_ATOL = 1e-4          # ragged sizes, images in [0, 255]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """A JAX (JPEG) folder and a port (PNG) folder of the same scene."""
    from dpe_mvs_tpu.utils.synthetic import make_plane_scene
    root = tmp_path_factory.mktemp("torch_scene")
    jsc = make_plane_scene(root / "jax", width=51, height=37, num_views=3,
                           seed=2)
    mem = tsynth.make_plane_scene(width=51, height=37, num_views=3, seed=2)
    tfolder = tsynth.write_scene_folder(mem, root / "port")
    return jsc.folder, tfolder, mem


def test_cam_txt_round_trips_both_ways(tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    rng = np.random.default_rng(0)
    K = rng.normal(size=(3, 3)).astype(np.float32)
    R = rng.normal(size=(3, 3)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    for write, read in ((tformats.write_cam_txt, jformats.read_cam_txt),
                        (jformats.write_cam_txt, tformats.read_cam_txt)):
        write(tmp_path / "c.txt", K, R, t, 1.25, 0.01, 192, 3.5)
        ours = tformats.read_cam_txt(tmp_path / "c.txt")
        ref = read(tmp_path / "c.txt")
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours[0], K)
        assert ours[3:] == (1.25, 3.5)
    # DTU: "depth_min interval" only.
    (tmp_path / "d.txt").write_text(
        "extrinsic\n" + " 0" * 16 + "\nintrinsic\n" + " 1" * 9
        + "\n1.0 0.5\n")
    assert tformats.read_cam_txt(tmp_path / "d.txt")[3:] == \
        jformats.read_cam_txt(tmp_path / "d.txt")[3:] == (1.0, 97.0)
    (tmp_path / "e.txt").write_text("extrinsic\nnot a number\n")
    with pytest.raises(ValueError):
        tformats.read_cam_txt(tmp_path / "e.txt")
    (tmp_path / "f.txt").write_text("extrinsics\n")
    with pytest.raises(ValueError, match="extrinsic"):
        tformats.read_cam_txt(tmp_path / "f.txt")


def test_pair_txt_round_trips_both_ways(tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    pairs = [(0, [(1, 12.5), (2, 0.0)]), (1, [(0, 3.25)]), (2, [])]
    for write, read in ((tformats.write_pair_txt, jformats.read_pair_txt),
                        (jformats.write_pair_txt, tformats.read_pair_txt)):
        write(tmp_path / "pair.txt", pairs)
        assert tformats.read_pair_txt(tmp_path / "pair.txt") == \
            read(tmp_path / "pair.txt") == pairs
    assert tformats.result_folder("/a", 7) == \
        jformats.result_folder("/a", 7)


def test_read_gray_equals_cv2_on_scene_folders(folders):
    from dpe_mvs_tpu.io import scene as jscene
    jfolder, tfolder, mem = folders
    for folder in (jfolder, tfolder):
        for v in range(3):
            ref = jscene.load_image_gray(folder, v)
            ours = imread.read_gray(tscene.image_path(folder, v))
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)
    assert (tfolder / "images" / "00000000.jpg").read_bytes()[:4] == \
        b"\x89PNG"
    np.testing.assert_array_equal(
        imread.read_gray(tscene.image_path(tfolder, 1)), mem.images[1])


def test_read_gray_equals_cv2_on_cv2_files(tmp_path):
    import cv2
    rng = np.random.default_rng(1)
    rgb = cv2.resize(rng.integers(0, 256, (12, 17, 3)).astype(np.uint8),
                     (67, 45), interpolation=cv2.INTER_CUBIC)
    rgba = np.concatenate(
        [rgb, rng.integers(0, 256, (45, 67, 1)).astype(np.uint8)], -1)
    gray = rgb[..., 1].copy()
    files = {"rgb.png": rgb, "rgba.png": rgba, "gray.png": gray,
             "gray.pgm": gray, "rgb.ppm": rgb, "rgb.jpg": rgb,
             "gray.jpg": gray}
    for name, img in files.items():
        params = [cv2.IMWRITE_JPEG_QUALITY, 90] if name.endswith("jpg") \
            else []
        assert cv2.imwrite(str(tmp_path / name), img, params)
        ref = cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(imread.read_gray_u8(tmp_path / name),
                                      ref, err_msg=name)
    imread.write_png_gray(tmp_path / "ours.png", gray)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "ours.png"), cv2.IMREAD_UNCHANGED), gray)
    (tmp_path / "x.jpg").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        imread.read_gray(tmp_path / "x.jpg")
    with pytest.raises(FileNotFoundError):
        imread.read_gray(tmp_path / "missing.png")


@pytest.mark.parametrize("quality", [1, 30, 50, 75, 95, 98, 100])
@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (1, 1), (9, 17)])
def test_jpeg_roundtrip_gray_equals_libjpeg(shape, quality):
    import cv2
    rng = np.random.default_rng(quality)
    noise = rng.integers(0, 256, shape).astype(np.uint8)
    smooth = cv2.GaussianBlur(noise, (5, 5), 1.5)
    for img in (noise, smooth, np.zeros(shape, np.uint8),
                np.full(shape, 255, np.uint8)):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                             quality])
        assert ok
        np.testing.assert_array_equal(
            imread.jpeg_roundtrip_gray(img, quality),
            cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError, match="quality"):
        imread.jpeg_roundtrip_gray(noise, 0)
    with pytest.raises(ValueError, match="uint8"):
        imread.jpeg_roundtrip_gray(noise.astype(np.float32), quality)


@pytest.mark.parametrize("shape", [(48, 64), (37, 51), (600, 800)])
def test_resize_linear(shape):
    from dpe_mvs_tpu.io import scene as jscene
    H, W = shape
    img = np.random.default_rng(H).integers(0, 256, (H, W)).astype(
        np.float32)
    for scale in (2, 4):
        cols, rows = tscene.scaled_size(W, H, scale)
        ours = tscene.resize_linear(img, cols, rows)
        ref = jscene.resize_linear(img, cols, rows)
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        if cols * scale == W and rows * scale == H:       # halvings
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_array_equal(tscene.resize_linear(img, W, H), img)


def test_sample_list_and_problem_inputs(folders, tmp_path):
    from dpe_mvs_tpu.io import formats as jformats
    from dpe_mvs_tpu.io import scene as jscene
    jfolder, _, _ = folders
    folder = tmp_path / "scene"
    shutil.copytree(jfolder, folder)
    pairs = jformats.read_pair_txt(folder / "pair.txt")
    pairs[1] = (pairs[1][0], [(0, 100.0), (2, 0.0)])   # score 0: dropped
    jformats.write_pair_txt(folder / "pair.txt", pairs)
    jprobs = jscene.generate_sample_list(folder)
    tprobs = tscene.generate_sample_list(folder)
    assert [(p.index, p.ref_image_id, p.src_image_ids) for p in tprobs] == \
        [(p.index, p.ref_image_id, p.src_image_ids) for p in jprobs]
    assert tprobs[1].src_image_ids == [0]
    assert [p.result_folder for p in tprobs] == \
        [p.result_folder for p in jprobs]
    assert tscene.check_images(tprobs) and jscene.check_images(jprobs)

    # Stored state at full size, so that scale 2 rescales it.
    rng = np.random.default_rng(3)
    H, W = 37, 51
    for p in jprobs:
        rf = p.result_folder
        jformats.write_dmb(rf / "depths.dmb",
                           rng.uniform(1, 5, (H, W)).astype(np.float32))
        jformats.write_dmb(rf / "normals.dmb",
                           rng.normal(size=(H, W, 3)).astype(np.float32))
        jformats.write_dmb(rf / "weak.bin",
                           rng.integers(0, 3, (H, W)).astype(np.uint8))
        jformats.write_dmb(rf / "selected_views.bin",
                           rng.integers(0, 4, (H, W)).astype(np.int32))
    for scale in (1, 2):
        for jp, tp in zip(jprobs, tprobs):
            kw = dict(need_prior=True, need_weak=True, need_src_depths=True)
            ref = jscene.load_problem_inputs(jp, scale, **kw)
            ours = tscene.load_problem_inputs(tp, scale, **kw)
            assert (ours.width, ours.height) == (ref.width, ref.height)
            assert (ours.depth_min, ours.depth_max) == \
                (ref.depth_min, ref.depth_max)
            for a, b in zip(ours.cameras, ref.cameras):
                for f in ("K", "R", "t", "depth_min", "depth_max", "width",
                          "height"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))
            np.testing.assert_allclose(ours.images, ref.images, rtol=0,
                                       atol=RESIZE_ATOL)
            for f in ("prior_depth", "prior_normal", "prior_selected_views",
                      "weak_info", "src_depths"):
                np.testing.assert_array_equal(getattr(ours, f),
                                              getattr(ref, f), err_msg=f)
    (folder / "images" / "00000002.jpg").unlink()
    assert not tscene.check_images(tprobs)
    with pytest.raises(FileNotFoundError):
        tscene.load_problem_inputs(tprobs[0], 1, need_prior=False,
                                   need_weak=False, need_src_depths=False)
