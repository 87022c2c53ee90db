"""The measured window: whole sweeps back to back for ``seconds``.

A sweep begun before the window's length has passed is finished and
counted, and the window runs from the first sweep's start to the last
sweep's synchronised end. Plain arithmetic over a clock, so that the tests
drive it with a fake one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence


@dataclasses.dataclass
class Window:
    starts: List[float]
    ends: List[float]

    @property
    def sweeps(self) -> int:
        return len(self.starts)

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0]


def run_window(sweep: Callable[[int], None], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call ``sweep(k)`` for k = 0, 1, ... while the window is open: the
    first sweep always, each later one only if it begins less than
    ``seconds`` after the first began. ``sweep`` returns once its work has
    ended on the device."""
    starts: List[float] = []
    ends: List[float] = []
    k = 0
    while True:
        t = clock()
        if starts and t - starts[0] >= seconds:
            break
        starts.append(t)
        sweep(k)
        ends.append(clock())
        k += 1
    return Window(starts, ends)


def mpix_per_s(window: Window, pixels: Sequence[int]) -> float:
    """Megapixels of every sweep's reference image over the window's
    seconds; ``pixels[k]`` is sweep k's."""
    if len(pixels) != window.sweeps:
        raise ValueError(f"{len(pixels)} pixel counts for {window.sweeps} "
                         f"sweeps")
    return sum(pixels) / 1e6 / window.seconds
