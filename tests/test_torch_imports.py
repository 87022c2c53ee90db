"""The PyTorch port stands alone: importing every module of
``dpe_mvs_tpu_torch`` (among them ``api``, ``cli``, ``pipeline.fusion``,
``utils.viz``, ``io.colmap``, ``parallel.mesh``, ``parallel.tiles`` and
``pipeline.parallel_schedule``), ``chip_smoke``, ``tools/torch_eval``,
``tools/torch_probe``, ``tools/torch_weak_compare`` and
``tools/torch_final_round`` loads neither ``jax``, nor any module of the JAX
package ``dpe_mvs_tpu``,
nor ``cv2`` (the machine with the card has none of them), and neither does
reading and writing PNG images through ``io/imread``; Pillow (``PIL``) is
not loaded either, as only a JPEG needs it. Checked in a fresh interpreter,
outside this suite's conftest (which imports jax)."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys, tempfile
from pathlib import Path
import numpy as np
import dpe_mvs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpe_mvs_tpu_torch.__path__,
                                               'dpe_mvs_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tools.torch_eval
import tools.torch_probe
import tools.torch_weak_compare
import tools.torch_final_round
from dpe_mvs_tpu_torch.io import imread
path = Path(tempfile.mkdtemp()) / '00000000.jpg'
img = np.arange(35, dtype=np.uint8).reshape(5, 7)
imread.write_png_gray(path, img)
assert (imread.read_gray(path) == img).all()
bgr = np.arange(105, dtype=np.uint8).reshape(5, 7, 3)
imread.write_png_color(path, bgr)
assert (imread.read_color_u8(path) == bgr).all()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'dpe_mvs_tpu', 'cv2', 'PIL'))
print(len(names), 'modules;', 'loaded:', bad)
print(' '.join(names))
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split()[0])
    assert n >= 36, res.stdout          # every module of the port was seen
    names = res.stdout.splitlines()[1].split()
    for mod in ("api", "cli", "edges.dual_level", "edges.imgproc",
                "io.imread", "io.scene", "utils.profiling",
                "pipeline.fusion", "utils.viz", "io.colmap",
                "parallel.mesh", "parallel.tiles",
                "pipeline.parallel_schedule"):
        assert f"dpe_mvs_tpu_torch.{mod}" in names


def test_port_sources_never_import_cv2():
    """Not even lazily, on any path."""
    for path in [*sorted((ROOT / "dpe_mvs_tpu_torch").rglob("*.py")),
                 ROOT / "chip_smoke.py", ROOT / "tools" / "torch_eval.py",
                 ROOT / "tools" / "torch_probe.py",
                 ROOT / "tools" / "torch_weak_compare.py",
                 ROOT / "tools" / "torch_final_round.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "cv2"]
                        or words[:2] == ["from", "cv2"]
                        or "import cv2" in line), f"{path}: {line}"
