"""The harness on the card at a size a test run can hold: a sound traced
run copies and checks launches of every kernel entry bit for bit and reads
the gathers' roofline within 100%; the control (the plain gathers in
bfloat16 in place of the kernels) fails the check. Run with
``python -m pytest -m gpu mvs_bench/tests -q -p no:cacheprovider`` on a
machine with a card; skipped without one."""
import pytest

from mvs_bench import cell, manifest as man, run as bench, window

NAME = "eth3d-r1.passB"
SIZE = dict(frame=[480, 360], rounds=2, views=4)


def _spec():
    m = man.load_manifest()
    w = man.cell(m, NAME)
    conf = dict(man.load_config(m, w["config"]), **SIZE)
    traffic = dict(man.load_traffic(w["traffic"]), round=1)
    return cell.CellSpec(name=NAME, config=conf, traffic=traffic)


@pytest.fixture
def three_sweeps(monkeypatch):
    def run_window(sweep, seconds):
        done = []
        return window.run_window(lambda k: (sweep(k), done.append(k)), 3.0,
                                 clock=lambda: float(len(done)))
    monkeypatch.setattr(cell, "run_window", run_window)


@pytest.mark.gpu
def test_sound_traced_run(cuda_device, three_sweeps, tmp_path):
    res = bench.run_cell(NAME, seed=2 ** 31 + 3, seconds=3.0, trace=True,
                         control=False, device=cuda_device, spec=_spec(),
                         limits=None, workdir=tmp_path)
    checks = res["checks"]
    assert checks["kernel_mismatch"]["value"] == 0
    assert checks["kernel_missing"]["value"] == 0
    assert len(res["_info"]["launches"]) == 3
    roof = res["metrics"]["gathers_roofline"]["value"]
    assert 0 < roof <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"]["device.launches_per_sweep"]["value"] > 1000


@pytest.mark.gpu
def test_control_fails(cuda_device, three_sweeps, tmp_path):
    res = bench.run_cell(NAME, seed=2 ** 31 + 5, seconds=3.0, trace=False,
                         control=True, device=cuda_device, spec=_spec(),
                         limits=None, workdir=tmp_path)
    assert res["checks"]["kernel_mismatch"]["value"] > 0
    assert res["correct"] is False
