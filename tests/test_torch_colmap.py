"""The PyTorch port's COLMAP converter (``io/colmap``) against the JAX
package's, on synthetic sparse models.

  * the three cases of ``tests/test_colmap.py``, with the workspace's images
    written by the port's own writer (no OpenCV);
  * ``colmap_to_dpe`` of both packages on one workspace (text and binary
    models, images of two sizes so that padding happens, scale factors 1
    and 2): cams and ``pair.txt`` byte for byte equal, images decoding
    (through OpenCV) to the same pixels;
  * ``resize_nearest`` equals ``cv2.resize(INTER_NEAREST)`` at ragged sizes;
  * the ``python -m dpe_mvs_tpu_torch.io.colmap`` entry point.
"""
import struct

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)
from dpe_mvs_tpu_torch.io import colmap, formats, imread


def make_colmap_scene(folder, n_images=3, n_points=60, seed=0,
                      ragged=False):
    """A COLMAP text model (PINHOLE, translated cameras) and colour PNG
    images; with ``ragged`` the images differ in size (padding)."""
    rng = np.random.default_rng(seed)
    (folder / "images").mkdir(parents=True)
    model = folder / "sparse" / "0"
    model.mkdir(parents=True)

    W, H, f = 64, 48, 60.0
    pts = np.stack([rng.uniform(-1, 1, n_points),
                    rng.uniform(-1, 1, n_points),
                    rng.uniform(4, 6, n_points)], -1)

    with open(model / "cameras.txt", "w") as fh:
        fh.write("# cameras\n")
        fh.write(f"1 PINHOLE {W} {H} {f} {f} {W/2} {H/2}\n")

    img_lines = ["# images"]
    for i in range(n_images):
        t = np.array([0.3 * i, 0.0, 0.0])
        q = np.array([1.0, 0, 0, 0])
        obs = []
        for pid in range(n_points):
            Xc = pts[pid] + t
            u = f * Xc[0] / Xc[2] + W / 2
            v = f * Xc[1] / Xc[2] + H / 2
            obs.append(f"{u} {v} {pid + 1}")
        img_lines.append(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                         f"{t[0]} {t[1]} {t[2]} 1 im{i}.png")
        img_lines.append(" ".join(obs))
    (model / "images.txt").write_text("\n".join(img_lines) + "\n")

    with open(model / "points3D.txt", "w") as fh:
        fh.write("# points\n")
        for pid in range(n_points):
            fh.write(f"{pid + 1} {pts[pid, 0]} {pts[pid, 1]} {pts[pid, 2]} "
                     f"10 20 30 0.5 0 0\n")

    for i in range(n_images):
        h, w = (H - 5 * i, W - 3 * i) if ragged else (H, W)
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        imread.write_png_color(folder / "images" / f"im{i}.png", img)
    return folder


def write_model_bin(model, txt_model):
    """The same model in COLMAP's binary format."""
    cams, images, points = colmap.read_model(txt_model, ".txt")
    with open(model / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = colmap.MODEL_NAME_TO_ID[c.model][0]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))
    with open(model / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, pid))
    with open(model / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", 0))


def test_colmap_to_dpe(tmp_path):
    src = make_colmap_scene(tmp_path / "colmap")
    out = tmp_path / "dpe"
    colmap.colmap_to_dpe(src, out)

    pairs = formats.read_pair_txt(out / "pair.txt")
    assert len(pairs) == 3
    # All views share all points -> every pair scored > 0 (baselines large
    # enough for > 1 deg triangulation).
    assert all(len(srcs) == 2 for _, srcs in pairs)
    assert all(s > 0 for _, srcs in pairs for _, s in srcs)

    K, R, t, dmin, dmax = formats.read_cam_txt(out / "cams" /
                                               "00000000_cam.txt")
    assert dmin > 0 and dmax > dmin
    # z range is [4, 6]; relaxed bounds 0.75x / 1.25x.
    assert 2.0 < dmin < 5.0
    assert 5.0 < dmax < 9.0
    np.testing.assert_allclose(K[0, 0], 60.0)

    img = imread.read_color_u8(out / "images" / "00000000.jpg")
    assert img.shape == (48, 64, 3)
    assert (out / "images" / "00000000.jpg").read_bytes()[:3] == \
        b"\xff\xd8\xff"


def test_qvec_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        if q[0] < 0:
            q = -q
        R = colmap.qvec2rotmat(q)
        q2 = colmap.rotmat2qvec(R)
        np.testing.assert_allclose(q2, q, atol=1e-6)


def test_bin_roundtrip(tmp_path):
    """Binary COLMAP reader against files synthesized in the bin format."""
    p = tmp_path / "cameras.bin"
    with open(p, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 7, 1, 100, 80))  # PINHOLE
        f.write(struct.pack("<dddd", 50.0, 51.0, 50.0, 40.0))
    cams = colmap.read_cameras_bin(p)
    assert cams[7].model == "PINHOLE"
    assert cams[7].width == 100
    np.testing.assert_allclose(cams[7].params, [50.0, 51.0, 50.0, 40.0])


@pytest.mark.parametrize("ext", [".txt", ".bin"])
@pytest.mark.parametrize("scale_factor", [1.0, 2.0])
def test_colmap_to_dpe_equals_jax(tmp_path, ext, scale_factor):
    import cv2
    from dpe_mvs_tpu.io import colmap as jcolmap
    src = make_colmap_scene(tmp_path / "colmap", n_images=4, seed=3,
                            ragged=True)
    model = src / "sparse" / "0"
    if ext == ".bin":
        binary = src / "sparse" / "1"
        binary.mkdir()
        write_model_bin(binary, model)
        model = binary
    a, b = tmp_path / "port", tmp_path / "jax"
    kw = dict(model_dir=model, model_ext=ext, scale_factor=scale_factor)
    colmap.colmap_to_dpe(src, a, **kw)
    jcolmap.colmap_to_dpe(src, b, **kw)
    assert (a / "pair.txt").read_bytes() == (b / "pair.txt").read_bytes()
    names = sorted(p.name for p in (b / "cams").iterdir())
    assert len(names) == 4
    assert sorted(p.name for p in (a / "cams").iterdir()) == names
    for n in names:
        assert (a / "cams" / n).read_bytes() == (b / "cams" / n).read_bytes()
    for i in range(4):
        name = f"{i:08d}.jpg"
        ours = cv2.imread(str(a / "images" / name))
        theirs = cv2.imread(str(b / "images" / name))
        assert ours.shape == (int(48 / scale_factor),
                              int(64 / scale_factor), 3)
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
        np.testing.assert_array_equal(
            imread.read_color_u8(a / "images" / name), theirs)


@pytest.mark.parametrize("size", [(48, 64), (37, 53), (600, 800)])
def test_resize_nearest_matches_cv2(size):
    import cv2
    rng = np.random.default_rng(size[1])
    img = rng.integers(0, 256, size + (3,), dtype=np.uint8)
    for sf in (0.7, 1.5, 2.0, 3.0, 7.0):
        cols, rows = int(size[1] / sf), int(size[0] / sf)
        np.testing.assert_array_equal(
            colmap.resize_nearest(img, cols, rows),
            cv2.resize(img, (cols, rows), interpolation=cv2.INTER_NEAREST))


def test_main_entry_point(tmp_path):
    src = make_colmap_scene(tmp_path / "colmap", n_images=2)
    out = tmp_path / "dpe"
    assert colmap.main(["--dense_folder", str(src), "--save_folder",
                        str(out), "--max_d", "128"]) == 0
    assert len(formats.read_pair_txt(out / "pair.txt")) == 2
    depth_line = (out / "cams" / "00000001_cam.txt").read_text().split()
    assert depth_line[-2] == "128.000000"          # depth_num = --max_d
