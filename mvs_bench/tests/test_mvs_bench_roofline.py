"""Each kernel's bytes and operations against a count made by hand at one
shape, and the bound's arithmetic."""
import pytest
import torch

from mvs_bench import roofline


def _work(name, *args):
    n_bytes, ops = roofline.launch_work(name, args, None)
    return int(n_bytes.item()), ops


def test_row_gather_by_hand():
    img = torch.zeros(2, 4)
    ix = torch.tensor([[0, 0, 5, -1], [1, 2, 2, 3]], dtype=torch.int32)
    # Row 0 touches columns {0, 3}, row 1 {1, 2, 3}: 5 words; 8 int32
    # indices and 8 float32 outputs.
    assert _work("row_gather", img, ix) == (4 * 5 + 32 + 32, 0)
    assert roofline.row_gather_work(2, 4, 5) == (84, 0)


def test_bilinear_x_by_hand():
    img = torch.zeros(1, 5)
    x = torch.tensor([[0.5, 3.9, 10.0, -2.0]])
    # Taps (0, 1), (3, 4), (3, 4), (0, 1): 4 distinct words; 4 columns in,
    # 4 values out, 10 operations each.
    assert _work("bilinear_x", img, x) == (4 * 4 + 16 + 16, 40)


def test_gather2d_by_hand():
    imgs = torch.zeros(3, 4, 5)
    iy = torch.tensor([[0, 0], [9, -1]], dtype=torch.int32)
    ix = torch.tensor([[1, 1], [2, 0]], dtype=torch.int32)
    # Pixels (0, 1), (3, 2), (0, 0) in 3 channels; 4 (iy, ix) queries; 3 x 4
    # outputs.
    assert _work("gather2d", imgs, iy, ix) == (3 * 4 * 3 + 32 + 48, 0)


def test_gather2d_hwc_by_hand():
    img = torch.zeros(4, 5, 2, dtype=torch.bool)
    iy = torch.tensor([0, 0, 1], dtype=torch.int32)
    ix = torch.tensor([0, 0, 4], dtype=torch.int32)
    # Two distinct 2-byte pixels, 3 queries of 8 bytes, 3 x 2 bytes out.
    assert _work("gather2d_hwc", img, iy, ix) == (4 + 24 + 6, 0)


def test_gather2d_pick_by_hand():
    imgs = torch.zeros(2, 3, 3, dtype=torch.int32)
    ic = torch.tensor([0, 1, 1, 5], dtype=torch.int64)
    z = torch.zeros(4, dtype=torch.int32)
    # Words (0, 0, 0) and (1, 0, 0); per query an 8-byte channel index, two
    # 4-byte coordinates and a 4-byte word out.
    assert _work("gather2d_pick", imgs, ic, z, z) == (8 + 4 * 16 + 16, 0)


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
