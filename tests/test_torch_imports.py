"""The PyTorch port stands alone: importing every module of
``dpe_mvs_tpu_torch`` and ``chip_smoke`` loads neither ``jax`` nor any
module of the JAX package ``dpe_mvs_tpu``. Checked in a fresh interpreter,
outside this suite's conftest (which imports jax)."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import dpe_mvs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpe_mvs_tpu_torch.__path__,
                                               'dpe_mvs_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'dpe_mvs_tpu'
             or m.startswith('dpe_mvs_tpu.'))
print(len(names), 'modules;', 'loaded:', bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split()[0])
    assert n >= 25, res.stdout          # every module of the port was seen
