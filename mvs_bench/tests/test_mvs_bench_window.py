"""The window's arithmetic on a fake clock."""
import pytest

from mvs_bench.window import Window, mpix_per_s, run_window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _sweeps(clock, durations):
    def sweep(k):
        clock.t += durations[k]
    return sweep


def test_whole_sweeps_and_overrun():
    clock = FakeClock()
    # Sweeps of 4 s in a 10-s window: begun at 0, 4 and 8 s; the third
    # overruns to 12 s and counts whole.
    win = run_window(_sweeps(clock, [4.0] * 10), 10.0, clock)
    assert win.sweeps == 3
    assert win.seconds == pytest.approx(12.0)
    assert mpix_per_s(win, [1_500_000] * 3) == pytest.approx(4.5 / 12.0)


def test_sweep_begun_just_before_the_end_counts():
    clock = FakeClock()
    win = run_window(_sweeps(clock, [9.99, 30.0, 1.0]), 10.0, clock)
    assert win.sweeps == 2
    assert win.seconds == pytest.approx(39.99)


def test_one_sweep_longer_than_the_window():
    clock = FakeClock()
    win = run_window(_sweeps(clock, [25.0, 1.0]), 10.0, clock)
    assert win.sweeps == 1
    assert mpix_per_s(win, [2_000_000]) == pytest.approx(2.0 / 25.0)


def test_pixel_counts_must_match_sweeps():
    with pytest.raises(ValueError):
        mpix_per_s(Window([0.0, 1.0], [1.0, 2.0]), [1])
