"""The port never imports jax or the JAX package (rs_bann_tpu), directly or
through any module it uses, and neither do the scripts that drive it on the
card: it keeps its own copies of what it needs.

Runs in a subprocess because tests/conftest.py imports jax in this one: a
``sys.meta_path`` finder raises on any import of jax or of rs_bann_tpu, then
every module of rs_bann_tpu_torch is imported and its CLI's ``--help`` runs.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "rs_bann_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, BlockJax())
import rs_bann_tpu_torch

names = [m.name for m in pkgutil.walk_packages(rs_bann_tpu_torch.__path__, "rs_bann_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "rs_bann_tpu") for m in sys.modules), "jax was imported"
for new in ("rs_bann_tpu_torch.ops.leapfrog", "rs_bann_tpu_torch.samplers.hmc",
            "rs_bann_tpu_torch.models.net", "rs_bann_tpu_torch.samplers.mcmc_cfg",
            "rs_bann_tpu_torch.models.arch", "rs_bann_tpu_torch.group.grouping",
            "rs_bann_tpu_torch.io.bed", "rs_bann_tpu_torch.io.phen", "rs_bann_tpu_torch.io.dims",
            "rs_bann_tpu_torch.cli.args", "rs_bann_tpu_torch.train", "rs_bann_tpu_torch.vis"):
    assert new in names, new
print(len(names))
from rs_bann_tpu_torch.cli.main import main
for argv in [["--help"]] + [[cmd, "--help"] for cmd in (
        "train-new", "train", "predict", "gradients", "branch-r2", "activations",
        "population-effect-sizes", "analyze")]:
    try:
        main(argv)
    except SystemExit as e:
        assert e.code == 0, e.code
"""


@pytest.mark.parametrize("script", ["chip_smoke.py", "scripts/profile_hybrid_torch.py",
                                    "scripts/build_time_torch.py", "scripts/bench_k5_torch.py"])
def test_card_scripts_import_only_the_port(script):
    """The card's scripts import neither jax nor the JAX package: what they
    need of it comes through rs_bann_tpu_torch."""
    tree = ast.parse((ROOT / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert any(n.startswith("rs_bann_tpu_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "rs_bann_tpu")]
    assert not bad, bad


def test_profile_script_runs_on_the_cpu_without_jax():
    """scripts/profile_hybrid_torch.py at a toy size on the CPU (its three
    hybrid cases, no profile), with any jax import raising."""
    run = SCRIPT.split("import rs_bann_tpu_torch")[0] + (
        "import runpy\n"
        "sys.argv = ['profile_hybrid_torch.py', '--device', 'cpu', '--groups', '2',"
        " '--n', '600', '--sweeps', '1']\n"
        "runpy.run_path('scripts/profile_hybrid_torch.py', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    for case in ("C=4 folded", "C=1 folded", "C=1 unfolded"):
        assert case + ": ms per sweep" in proc.stdout, proc.stdout


def test_profile_script_flagship_runs_on_the_cpu_without_jax():
    """The same with ``--flagship`` (the dense parallel sweep on feature-major
    X, and the sequential one) at a toy size."""
    run = SCRIPT.split("import rs_bann_tpu_torch")[0] + (
        "import runpy\n"
        "sys.argv = ['profile_hybrid_torch.py', '--device', 'cpu', '--flagship', '--groups', '2',"
        " '--n', '300', '--sweeps', '1']\n"
        "runpy.run_path('scripts/profile_hybrid_torch.py', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120,
        # one thread: the tests' workers share the cores
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    for case in ("C=4 folded", "C=1 folded", "C=1 unfolded", "C=1 sequential"):
        assert case + ": ms per sweep" in proc.stdout, proc.stdout
    assert "(K7, K6, K8a, K8b, K8 forward-only)" in proc.stdout


def test_profile_script_gd_runs_on_the_cpu_without_jax():
    """The same with ``--gd`` (the GD warm-start sweep, identity and silu)
    at a toy size."""
    run = SCRIPT.split("import rs_bann_tpu_torch")[0] + (
        "import runpy\n"
        "sys.argv = ['profile_hybrid_torch.py', '--device', 'cpu', '--gd', '--groups', '2',"
        " '--n', '600', '--sweeps', '1']\n"
        "runpy.run_path('scripts/profile_hybrid_torch.py', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    for case in ("GD warm start identity C=4", "GD warm start silu C=4"):
        assert case + ": ms per sweep" in proc.stdout, proc.stdout
    assert "(K2, K3, K9a, K9b)" in proc.stdout


def test_chip_smoke_without_a_card_exits_nonzero_before_any_result():
    """chip_smoke.py with jax and the JAX package blocked and no CUDA device:
    its imports load, and it stops at phase 0 with a non-zero code and no
    result line."""
    run = SCRIPT.split("import rs_bann_tpu_torch")[0] + (
        "import runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr
    assert '"ok"' not in proc.stdout


def test_feat_major_sequential_and_unfolded_run_without_jax(tmp_path):
    """train-new --feat-major --cpu under the sequential schedule (K8a's plain
    version) and the unfolded hybrid one (K8b's), then dense predict, at a
    toy size with any jax import raising."""
    run = SCRIPT.split("import rs_bann_tpu_torch")[0] + f"""
import numpy as np
from rs_bann_tpu_torch.cli.main import main
from rs_bann_tpu_torch.io import BedVM, Phenotypes, UniformGrouping
d = {str(tmp_path)!r}
BedVM.random(200, 6, seed=1).to_file(d + "/train")
Phenotypes(np.random.default_rng(0).standard_normal(200).astype(np.float32)).to_file(
    d + "/train.phen")
UniformGrouping(2, 3).to_file(d + "/train")
for extra in ([], ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "2"]):
    main(["train-new", d + "/train", d + "/train.phen", d + "/train.groups", "ridge_base",
          "tanh", "1", "2", "3", "--fixed-hidden-layer-width", "4", "--fixed-summary-layer-width",
          "4", "--feat-major", "--cpu", "-o", d + "/runs", *extra])
"""
    proc = subprocess.run(
        [sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    runs = sorted((tmp_path / "runs").iterdir())
    assert len(runs) == 2
    assert (runs[0] / "models" / "2.npz").exists()
    assert (runs[1] / "models" / "chain1" / "2.npz").exists()
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.split("import rs_bann_tpu_torch")[0]
         + "from rs_bann_tpu_torch.cli.main import main\n"
         + f"main(['predict', {str(tmp_path / 'train')!r}, {str(tmp_path / 'train.groups')!r}, "
         + f"'-m', {str(runs[0] / 'models')!r}, '--cpu'])\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 2


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split("\n")[0])
    assert n_modules >= 24
    assert "train-new" in proc.stdout and "--packed-genotypes" in proc.stdout
    assert "gradients" in proc.stdout
