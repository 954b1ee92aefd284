"""The port's CLI end to end on the CPU: ``train-new --packed-genotypes`` then
``predict``, and the JAX package's ``Net.load`` + ``predict`` on the port's
saved samples must reproduce the port's CSV (rtol 1e-5). Every option
outside the ported slice exits non-zero with "not ported yet".
"""

import csv
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from rs_bann_tpu.group.grouping import ExternalGrouping, UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.io.phen import Phenotypes
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.data import pack_stacked as j_pack_stacked
from rs_bann_tpu_torch.cli.main import main

G, M, N_TRAIN, N_TEST = 3, 10, 700, 300


def run_cli(*argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main([str(a) for a in argv])
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


UNPORTED = [
    ["--update-mode", "parallel"],
    ["--update-mode", "hybrid"],
    ["--num-chains", "2"],
    ["--joint-hmc"],
    ["--gradient-descent"],
    ["--gradient-descent-joint"],
    ["--gd-warmup", "2"],
    ["--spike-slab"],
    ["--ss-markers"],
    ["--ss-rows"],
    ["--tempering", "--num-chains", "2"],
    ["--mass-adaptation"],
    ["--step-size-mode", "dual_averaging"],
    ["--traj-length-mode", "jittered"],
    ["--trajectories"],
    ["--num-grad"],
    ["--num-grad-traj"],
    ["--effect-sizes"],
    ["--feat-major"],
    ["--bf16"],
    ["--checkpoint-interval", "2"],
    ["--resume", "checkpoint.npz"],
]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda a: " ".join(a))
def test_unported_options_exit_nonzero(data, tmp_path, extra, capsys):
    with pytest.raises(SystemExit) as e:
        run_cli(*_train_args(data, tmp_path, "--packed-genotypes", *extra))
    assert e.value.code not in (0, None)
    assert "not ported yet" in str(e.value.code)
    assert not any(tmp_path.iterdir())  # refused before writing anything


def test_dense_and_silu_exit_nonzero(data, tmp_path):
    for argv in (
        _train_args(data, tmp_path),  # dense genotypes
        _train_args(data, tmp_path, "--packed-genotypes")[:4] + ["ridge_ard", "silu"]
        + _train_args(data, tmp_path, "--packed-genotypes")[6:],
        ["predict", data / "test", data / "train.groups", "-m", tmp_path, "--cpu"],
    ):
        with pytest.raises(SystemExit) as e:
            run_cli(*argv)
        assert "not ported yet" in str(e.value.code)
