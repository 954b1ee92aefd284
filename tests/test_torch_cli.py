"""The port's CLI end to end on the CPU: ``train-new --packed-genotypes`` then
``predict``, and the JAX package's ``Net.load`` + ``predict`` on the port's
saved samples must reproduce the port's CSV (rtol 1e-5), for one chain and
for C chains (``models/chain<c>``) under the sequential and the hybrid
schedule, with the GD warm start, gradient descent and silu too; the same
for ``train-new --feat-major`` under the parallel and hybrid schedules with
dense ``predict``, and under the sequential schedule (one chain and two)
and the unfolded hybrid one, and with dual averaging and mass adaptation on
every schedule and layout. ``gradients --cpu`` writes the JAX package's JSON
(rtol 1e-4 of each array's largest entry). Every option outside the ported
slice exits non-zero with "not ported yet" (``--checkpoint-interval``,
``--resume`` and ``--effect-sizes`` are ported: tests/test_torch_checkpoint.py
and tests/test_torch_analysis.py).
"""

import csv
import io
import json
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

from rs_bann_tpu.group.grouping import ExternalGrouping, UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.io.genotypes import CompressedGenotypes as JCompressedGenotypes
from rs_bann_tpu.io.phen import Phenotypes
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.cli.main import main as jax_main
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu_torch.cli.main import main

G, M, N_TRAIN, N_TEST = 3, 10, 700, 300


def run_cli(*argv, cli=main):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli([str(a) for a in argv])
    return buf.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for stem, n, seed in [("train", N_TRAIN, 1), ("test", N_TEST, 2)]:
        BedVM.random(n, G * M, seed=seed).to_file(d / stem)
        Phenotypes(rng.standard_normal(n).astype(np.float32)).to_file(d / f"{stem}.phen")
    UniformGrouping(G, M).to_file(d / "train")
    return d


def _train_args(d, out, *extra):
    return [
        "train-new", d / "train", d / "train.phen", d / "train.groups",
        "ridge_ard", "identity", "0", "4", "5",
        "--fixed-hidden-layer-width", "6", "--burn-in", "1",
        "--bfile-test", d / "test", "--p-test", d / "test.phen",
        "--seed", "3", "--cpu", "-o", out, *extra,
    ]


def test_train_new_then_predict_and_jax_reads_the_samples(data, tmp_path):
    out = run_cli(*_train_args(data, tmp_path, "--packed-genotypes", "--trace"))
    run = tmp_path / out.strip().splitlines()[-1].split("/")[-1]
    assert {"args.json", "hyperparams", "training_stats", "trace", "models"} <= {
        p.name for p in run.iterdir()
    }
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G
    assert len(stats["mse_train"]) == len(stats["mse_test"]) == len(stats["lpd"]) == 5
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    assert len((run / "trace").read_text().splitlines()) == 5
    models = sorted(p.name for p in (run / "models").iterdir())
    assert models == ["1.npz", "2.npz", "3.npz", "4.npz"]

    rows = list(csv.reader(io.StringIO(run_cli(
        "predict", data / "test", data / "train.groups", "-m", run / "models",
        "--packed-genotypes", "--cpu",
    ))))
    assert len(rows) == 4 and all(len(r) == N_TEST for r in rows)
    port = np.asarray(rows, np.float64)
    assert np.all(np.isfinite(port))

    bed = BedVM.from_file(data / "test")
    grouping = ExternalGrouping.from_file(data / "train.groups")
    X = None
    for i, name in enumerate(models):
        net = JN.Net.load(str(run / "models" / name))
        if X is None:
            X = j_pack_stacked(net.arch, bed, grouping, np.zeros(N_TEST)).X
        np.testing.assert_allclose(np.asarray(net.predict(X)), port[i], rtol=1e-5, atol=1e-5)


def _predict_matches_jax(data, models, expect, packed=True):
    """predict on a models directory (packed or dense genotypes), and JAX's
    Net.load + predict on the same samples (rtol 1e-5)."""
    names = sorted(p.name for p in models.iterdir())
    assert names == expect
    rows = list(csv.reader(io.StringIO(run_cli(
        "predict", data / "test", data / "train.groups", "-m", models, "--cpu",
        *(["--packed-genotypes"] if packed else []),
    ))))
    port = np.asarray(rows, np.float64)
    assert port.shape == (len(names), N_TEST) and np.all(np.isfinite(port))
    bed = BedVM.from_file(data / "test")
    grouping = ExternalGrouping.from_file(data / "train.groups")
    for i, name in enumerate(names):
        net = JN.Net.load(str(models / name))
        if packed:
            X = j_pack_stacked(net.arch, bed, grouping, np.zeros(N_TEST)).X
        else:
            X = JCompressedGenotypes(bed, grouping).to_stacked(net.arch).X
        np.testing.assert_allclose(np.asarray(net.predict(X)), port[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra,chains", [
    (["--update-mode", "hybrid"], 1),
    (["--num-chains", "2"], 2),
    (["--update-mode", "hybrid", "--num-chains", "2", "--block-size", "3"], 2),  # folded
    (["--update-mode", "hybrid", "--num-chains", "2", "--per-chain-block-perm"], 2),
], ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_hybrid_and_chains_train_then_jax_reads_the_samples(data, tmp_path, extra, chains):
    out = run_cli(*_train_args(data, tmp_path, "--packed-genotypes", *extra))
    run = tmp_path / out.strip().splitlines()[-1].split("/")[-1]
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G * chains
    assert len(stats["mse_train"]) == len(stats["mse_test"]) == len(stats["lpd"]) == 5
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    samples = ["1.npz", "2.npz", "3.npz", "4.npz"]
    if chains == 1:
        _predict_matches_jax(data, run / "models", samples)
    else:
        assert sorted(p.name for p in (run / "models").iterdir()) == ["chain0", "chain1"]
        for c in range(chains):
            _predict_matches_jax(data, run / "models" / f"chain{c}", samples)


@pytest.mark.parametrize("extra,chains", [
    (["--update-mode", "parallel", "--num-chains", "2"], 2),
    (["--update-mode", "hybrid", "--block-size", "1"], 1),
    ([], 1),  # sequential: K8a per leapfrog step
    (["--num-chains", "2"], 2),  # sequential, chain after chain
    # unfolded hybrid: each block's (chain, branch) pairs batched on K8b
    (["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "2"], 2),
], ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_feat_major_train_then_dense_predict_and_jax_reads_the_samples(data, tmp_path, extra,
                                                                        chains):
    argv = _train_args(data, tmp_path, "--feat-major", *extra)
    argv[4:7] = ["ridge_base", "tanh", "1"]
    out = run_cli(*argv, "--fixed-summary-layer-width", "4")
    run = tmp_path / out.strip().splitlines()[-1].split("/")[-1]
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G * chains
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    samples = ["1.npz", "2.npz", "3.npz", "4.npz"]
    dirs = [run / "models"] if chains == 1 else [run / "models" / f"chain{c}" for c in range(chains)]
    for d in dirs:
        _predict_matches_jax(data, d, samples, packed=False)


UNPORTED = [
    ["--joint-hmc"],
    ["--gradient-descent-joint"],
    ["--spike-slab"],
    ["--ss-rows"],
    ["--tempering", "--num-chains", "2"],
    ["--traj-length-mode", "jittered"],
    ["--trajectories"],
    ["--num-grad"],
    ["--num-grad-traj"],
    ["--x-bf16", "--feat-major"],
    ["--x-bf16", "--feat-major", "--update-mode", "parallel"],
    ["--feat-major", "--update-mode", "parallel", "--bf16"],
    ["--bf16"],
]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda a: " ".join(a))
def test_unported_options_exit_nonzero(data, tmp_path, extra, capsys):
    layout = [] if "--feat-major" in extra else ["--packed-genotypes"]
    with pytest.raises(SystemExit) as e:
        run_cli(*_train_args(data, tmp_path, *layout, *extra))
    assert e.value.code not in (0, None)
    assert "not ported yet" in str(e.value.code)
    assert not any(tmp_path.iterdir())  # refused before writing anything


def test_analyze_plots_exit_nonzero(data, tmp_path):
    """analyze --plots waits for a later slice (the JAX package's plots need
    matplotlib and do no device work): it exits "not ported yet" before
    reading the run or writing the plot directory."""
    with pytest.raises(SystemExit) as e:
        run_cli("analyze", tmp_path / "run", "--plots", tmp_path / "plots")
    assert "not ported yet: analyze --plots" in str(e.value.code)
    assert not any(tmp_path.iterdir())


# three warm sweeps of four: at the default factor 1 the toy run accepts
# nothing without the adaptation
ADAPTED = ["--step-size-mode", "dual_averaging", "--mass-adaptation", "--burn-in", "3"]


@pytest.mark.parametrize("layout,extra,chains", [
    ("--packed-genotypes", ["--update-mode", "hybrid", "--num-chains", "2", "--block-size", "3"],
     2),  # folded: K5
    ("--packed-genotypes", [], 1),  # sequential: K4
    ("--packed-genotypes", ["--update-mode", "hybrid", "--per-chain-block-perm",
                            "--num-chains", "2"], 2),  # unfolded: K4
    ("--feat-major", ["--update-mode", "parallel", "--num-chains", "2"], 2),  # folded: K6/K7
    ("--feat-major", ["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "2"],
     2),  # unfolded: K8b
], ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_dual_averaging_and_mass_adaptation_train_then_predict(data, tmp_path, layout, extra,
                                                               chains):
    """train-new with --step-size-mode dual_averaging --mass-adaptation runs
    on every schedule and layout, writes the ``_mass`` run directory with
    finite statistics and some accepted and some rejected moves, and JAX
    predicts its samples as the port does."""
    argv = _train_args(data, tmp_path, layout, *extra, *ADAPTED)
    if layout == "--feat-major":
        argv[4:7] = ["ridge_base", "tanh", "1"]
        argv += ["--fixed-summary-layer-width", "4"]
    run = _run_dir(tmp_path, run_cli(*argv))
    assert "_dual_averaging_" in run.name and "_mass_" in run.name
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G * chains
    assert 0 < stats["num_accepted"] < stats["num_samples"]
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    samples = ["3.npz", "4.npz"]  # from the last warm sweep on
    dirs = ([run / "models"] if chains == 1
            else [run / "models" / f"chain{c}" for c in range(chains)])
    for d in dirs:
        _predict_matches_jax(data, d, samples, packed=layout == "--packed-genotypes")


SCHEDULES = {  # schedule -> (its options, the kernels that run it on the card)
    "parallel": (["--update-mode", "parallel"], "K6/K7"),
    "sequential": ([], "K8"),
    "unfolded": (["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "2"],
                 "K8"),
}


@pytest.mark.parametrize("depth,width,schedule", [
    pytest.param(d, w, sch, id=f"{d}-{w}" + ("" if sch == "parallel" else f"-{sch}"))
    for sch in SCHEDULES for d, w in (("1", "64"), ("2", "6"))])
def test_feat_major_beyond_the_kernels_is_refused_on_cuda(data, tmp_path, monkeypatch, depth,
                                                           width, schedule):
    """On a CUDA device a --feat-major branch beyond the kernels' limits
    (width above 32, depth above 1) exits "not ported yet" naming the
    kernels of its schedule (K6/K7 folded, K8 sequential or unfolded) before
    anything is written or put on the device, instead of running the plain
    version. The device is faked: the check comes before the first CUDA
    tensor."""
    import torch

    from rs_bann_tpu_torch.cli import main as cli_main

    monkeypatch.setattr(cli_main, "_device", lambda args: torch.device("cuda"))
    extra, kernels = SCHEDULES[schedule]
    argv = _train_args(data, tmp_path, "--feat-major", *extra)
    argv[4:7] = ["ridge_base", "tanh", depth]
    argv[argv.index("--fixed-hidden-layer-width") + 1] = width
    with pytest.raises(SystemExit) as e:
        run_cli(*argv)
    assert "not ported yet" in str(e.value.code) and f"the {kernels} CUDA" in str(e.value.code)
    assert not any(tmp_path.iterdir())


PACKED_SCHEDULES = {  # schedule -> (its options, the kernel that runs it on the card)
    "folded": (["--update-mode", "hybrid", "--num-chains", "2", "--block-size", "3"], "K5"),
    "sequential": ([], "K4"),
    "unfolded": (["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "2"],
                 "K4"),
}


@pytest.mark.parametrize("depth,width,schedule", [
    pytest.param(d, w, sch, id=f"{d}-{w}-{sch}")
    for sch in PACKED_SCHEDULES for d, w in (("0", "64"), ("2", "6"))])
def test_packed_beyond_the_kernels_is_refused_on_cuda(data, tmp_path, monkeypatch, depth, width,
                                                       schedule):
    """The same for a --packed-genotypes HMC run: a branch beyond K5's
    limits (folded) or K4's (sequential or unfolded) exits "not ported yet"
    naming the kernel, before anything is written or loaded onto the
    device."""
    import torch

    from rs_bann_tpu_torch.cli import main as cli_main

    monkeypatch.setattr(cli_main, "_device", lambda args: torch.device("cuda"))
    extra, kernel = PACKED_SCHEDULES[schedule]
    argv = _train_args(data, tmp_path, "--packed-genotypes", *extra)
    argv[6] = depth
    argv[argv.index("--fixed-hidden-layer-width") + 1] = width
    with pytest.raises(SystemExit) as e:
        run_cli(*argv)
    assert "not ported yet" in str(e.value.code) and f"the {kernel} CUDA" in str(e.value.code)
    assert "--packed-genotypes" in str(e.value.code)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("extra,refused", [
    (["--gradient-descent"], False),
    (["--gradient-descent", "--update-mode", "hybrid", "--num-chains", "2"], False),
    (["--gd-warmup", "1"], True),  # GD warms up, HMC on K4 samples
])
def test_packed_gradient_descent_is_not_refused(data, tmp_path, extra, refused):
    """Gradient descent as the sampler runs K2, K3 and K9 at any width, so
    a packed run at width 64 on the card is not refused; HMC after a GD
    warm start is."""
    import torch

    from rs_bann_tpu_torch.cli import main as cli_main
    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.models import NetArch

    argv = _train_args(data, tmp_path, "--packed-genotypes", *extra)
    argv[argv.index("--fixed-hidden-layer-width") + 1] = "64"
    args = cli_main.build_parser().parse_args([str(a) for a in argv])
    cfg = mcmc_cfg_from_args(args, str(tmp_path))
    arch = NetArch.uniform(G, M, 64, 0, activation="identity")
    bad = cli_main._beyond_kernels(args, cfg, arch, torch.device("cuda"))
    assert bool(bad) == refused
    assert cli_main._beyond_kernels(args, cfg, arch, torch.device("cpu")) == []


def test_dense_and_silu_exit_nonzero(data, tmp_path):
    """Dense sample-major training waits for a later slice (silu on packed
    genotypes no longer does: K9); --feat-major with --packed-genotypes is
    refused as in JAX."""
    with pytest.raises(SystemExit) as e:
        run_cli(*_train_args(data, tmp_path))  # dense sample-major genotypes
    assert "not ported yet" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        run_cli(*_train_args(data, tmp_path, "--packed-genotypes", "--feat-major",
                             "--update-mode", "parallel"))
    assert "mutually exclusive" in str(e.value.code)
    assert not any(tmp_path.iterdir())


@pytest.fixture
def one_thread():
    """Gradient descent's line search runs many small ops; with the test
    workers sharing the cores, one intra-op thread keeps them from waiting
    on each other."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run_dir(tmp_path, out):
    return tmp_path / out.strip().splitlines()[-1].split("/")[-1]


@pytest.mark.parametrize("extra,chains", [
    (["--gradient-descent"], 1),
    (["--gd-warmup", "2"], 1),
    (["--gd-warmup", "2", "--update-mode", "hybrid", "--num-chains", "2"], 2),
], ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_gradient_descent_and_gd_warmup_then_jax_reads_the_samples(data, tmp_path, one_thread,
                                                                    extra, chains):
    """Gradient descent as the sampler (sequential), and the GD warm start
    before sequential or hybrid sampling: finite statistics, the warm start
    counts no branch updates, and JAX predicts the port's samples."""
    run = _run_dir(tmp_path, run_cli(*_train_args(data, tmp_path, "--packed-genotypes", *extra)))
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G * chains
    if "--gradient-descent" in extra:
        assert stats["num_accepted"] == stats["num_samples"]
    assert len(stats["mse_train"]) == len(stats["mse_test"]) == len(stats["lpd"]) == 5
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    samples = ["1.npz", "2.npz", "3.npz", "4.npz"]
    dirs = ([run / "models"] if chains == 1
            else [run / "models" / f"chain{c}" for c in range(chains)])
    for d in dirs:
        _predict_matches_jax(data, d, samples)


def test_silu_on_packed_genotypes_then_jax_reads_the_samples(data, tmp_path, one_thread):
    """silu on packed genotypes (layer 0 on K9a's plain version), hybrid with
    the folded transition, then packed predict against JAX's."""
    argv = _train_args(data, tmp_path, "--packed-genotypes", "--update-mode", "hybrid")
    argv[5] = "silu"
    run = _run_dir(tmp_path, run_cli(*argv))
    stats = json.loads((run / "training_stats").read_text())
    assert stats["num_samples"] == 4 * G
    assert all(np.isfinite(stats["mse_train"] + stats["mse_test"] + stats["lpd"]))
    _predict_matches_jax(data, run / "models", ["1.npz", "2.npz", "3.npz", "4.npz"])


@pytest.mark.parametrize("act", ["identity", "silu"])
def test_gradients_json_matches_jax(data, tmp_path, one_thread, act):
    """gradients --packed-genotypes --cpu on the port's samples writes the
    JSON JAX's gradients writes on the same samples (each array within rtol
    1e-4 of its largest entry: f32 sums over n in another order)."""
    argv = _train_args(data, tmp_path, "--packed-genotypes")
    argv[5] = act
    run = _run_dir(tmp_path, run_cli(*argv))
    shutil.copytree(run / "models", tmp_path / "jax" / "models")
    dirs = {}
    for name, models, cli in (("port", run / "models", main),
                              ("jax", tmp_path / "jax" / "models", jax_main)):
        out = run_cli("gradients", data / "test", data / "test.phen", data / "train.groups",
                      "-m", models, "--packed-genotypes", "--cpu", cli=cli)
        dirs[name] = models.parent / "gradients"
        assert out.strip().splitlines()[-1] == str(dirs[name])
    files = sorted(p.name for p in dirs["port"].iterdir())
    assert files == sorted(p.name for p in dirs["jax"].iterdir()) == [
        "1.json", "2.json", "3.json", "4.json"]
    for f in files:
        port, ref = (json.loads((dirs[k] / f).read_text()) for k in ("port", "jax"))
        assert len(port) == len(ref) == G
        for bp, bj in zip(port, ref):
            assert set(bp) == set(bj) == {"wrt_weights", "wrt_biases"}
            for key in bp:
                assert len(bp[key]) == len(bj[key])
                for a, b in zip(bp[key], bj[key]):
                    a, b = np.asarray(a), np.asarray(b)
                    assert a.shape == b.shape
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
