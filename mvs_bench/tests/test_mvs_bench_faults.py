"""The check against a broken timed path, on the CPU at a size a test run
can hold: the harness's whole run (set-up, window, probes, reference)
without its look for a card, the program broken underneath
(:mod:`mvs_bench.faults`). A sound run passes limits set from its own
readings; each fault that the cell can have (a sweep that returns its state
unchanged, half the frame left out, a kernel's answer altered, a written
depth, normal or weak label altered, the weak stage skipped) and the control
(the plain gathers in bfloat16 in place of the kernels) fail them. The cell
runs on one card, so no exchange between cards can be left out."""
import contextlib

import numpy as np
import pytest
import torch

from mvs_bench import cell, faults, manifest as man, readings
from mvs_bench import run as bench, window

NAME = "eth3d-r1.passB"
SIZE = dict(frame=[64, 48], rounds=2, views=3)


def _spec():
    m = man.load_manifest()
    w = man.cell(m, NAME)
    conf = dict(man.load_config(m, w["config"]), **SIZE)
    traffic = dict(man.load_traffic(w["traffic"]), round=1)
    return cell.CellSpec(name=NAME, config=conf, traffic=traffic)


@pytest.fixture
def two_sweeps(monkeypatch):
    """A window of exactly two sweeps (a clock that counts them)."""
    def run_window(sweep, seconds):
        done = []
        return window.run_window(lambda k: (sweep(k), done.append(k)), 2.0,
                                 clock=lambda: float(len(done)))
    monkeypatch.setattr(cell, "run_window", run_window)
    torch.set_num_threads(min(4, torch.get_num_threads()))


def _numbers(tmp_path, fault=None, control=False):
    res = bench.run_cell(NAME, seed=2 ** 31 + 17, seconds=2.0, trace=False,
                         control=control, device="cpu", spec=_spec(),
                         limits={}, workdir=tmp_path, fault=fault)
    return res["_info"]["numbers"]


def _limits(sound):
    """The cell's compared numbers, each at twice its sound reading (the
    shares of pixels at least 0.1 above it), so that the sound run
    passes."""
    def limit(k):
        if k.startswith("kernel_"):
            return 0.0
        if k.endswith("unchanged") or k.startswith("invalid"):
            return max(2 * sound[k], sound[k] + 0.1)
        return max(2 * sound[k], 1e-6)
    return {k: limit(k) for k in man.load_limits(NAME)}


def _box(run):
    return faults.patch_box(run.scene, run.scale_size)


FAULTS = {
    "state_unchanged": lambda run: faults.state_unchanged(),
    "half_frame": lambda run: faults.half_frame(),
    "kernel_altered": lambda run: faults.kernel_altered(),
    "depth_altered": lambda run: faults.at_write("depth_altered", None),
    "patch_depth_altered": lambda run: faults.at_write(
        "patch_depth_altered", _box(run)),
    "normals_rotated": lambda run: faults.at_write("normals_rotated", None),
    "patch_unknown": lambda run: faults.at_write("patch_unknown", _box(run)),
    "weak_skipped": lambda run: faults.weak_skipped(),
}


@pytest.mark.parametrize("fault_name", sorted(FAULTS))
def test_a_fault_fails_the_check(fault_name, tmp_path, two_sweeps):
    sound = _numbers(tmp_path)
    limits = _limits(sound)
    assert sound["kernel_mismatch"] == 0 and sound["kernel_missing"] == 0
    with contextlib.ExitStack() as stack:
        got = _numbers(tmp_path, fault=lambda run: stack.enter_context(
            FAULTS[fault_name](run)))
    failed = sorted(k for k in limits if not got[k] <= limits[k])
    assert failed, (fault_name, got, limits)
    if fault_name == "kernel_altered":
        assert "kernel_mismatch" in failed


def test_the_control_fails_the_check(tmp_path, two_sweeps):
    limits = _limits(_numbers(tmp_path))
    got = _numbers(tmp_path, control=True)
    assert "kernel_mismatch" in sorted(k for k in limits
                                       if not got[k] <= limits[k])


def test_rotated_normals_turn_by_the_angle():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(50, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    r = faults.rotate_normals(n, 5.0).astype(np.float64)
    ang = np.degrees(np.arccos(np.clip((n * r).sum(1), -1, 1)))
    assert np.allclose(ang, 5.0, atol=1e-3)
    assert np.allclose(np.linalg.norm(r, axis=1), 1.0, atol=1e-6)


def test_readings_in_one_process(tmp_path):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = readings.read_all(NAME, [5, 6], 3, 1, ["weak_skipped", "control"],
                            [2], "cpu", spec=_spec(), workdir=tmp_path)
    assert res["sound"]["views"] == [0, 1, 0]
    assert len(res["sound"]["worst_per_seed"]) == 2
    assert res["sound"]["kernels"]["kernel_mismatch"] == 0
    assert res["control"]["kernels"]["kernel_mismatch"] > 0
    assert res["views"]["views"] == [2]
    for name in faults.MAP_FAULTS:
        assert name in res
    assert res["patch_unknown"]["worst_per_seed"][0]["invalid_patch"] == 1.0
