"""The port never imports jax, directly or through any module it uses.

Runs in a subprocess because tests/conftest.py imports jax in this one: a
``sys.meta_path`` finder raises on any jax import, then every module of
rs_bann_tpu_torch is imported and its CLI's ``--help`` runs.
"""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, BlockJax())
import rs_bann_tpu_torch

names = [m.name for m in pkgutil.walk_packages(rs_bann_tpu_torch.__path__, "rs_bann_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax was imported"
print(len(names))
from rs_bann_tpu_torch.cli.main import main
for argv in (["--help"], ["train-new", "--help"], ["predict", "--help"]):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code == 0, e.code
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split("\n")[0])
    assert n_modules >= 15
    assert "train-new" in proc.stdout and "--packed-genotypes" in proc.stdout
