"""The port's analysis paths against the JAX package on the CPU: ``Net``'s
``branch_r2s``, ``activations``, ``effect_sizes``,
``population_effect_sizes`` and ``perturb``, the ``branch-r2``,
``activations``, ``population-effect-sizes``, ``analyze`` and ``train``
subcommands, and ``train-new --effect-sizes``.

Every comparison is on the same sample, saved by the JAX package (the
methods, ``train``) or by the port (the subcommands), and holds each array
within 1e-5 of its largest entry (f32 sums in another order): packed
genotypes at all five activations, depth 0 and 1, dense sample-major and
feature-major ones. ``perturb`` is bit for bit and ``analyze``'s JSON
equal.
"""

import csv
import io
import json
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from rs_bann_tpu.cli.main import main as jax_main
from rs_bann_tpu.group.grouping import ExternalGrouping, UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.io.genotypes import CompressedGenotypes as JGenotypes
from rs_bann_tpu.io.phen import Phenotypes
from rs_bann_tpu.models import density as JD
from rs_bann_tpu.models import net as JN
from rs_bann_tpu.models.arch import NetArch as JNetArch
from rs_bann_tpu.models.init import InitCfg as JInitCfg
from rs_bann_tpu.models.init import init_net as j_init_net
from rs_bann_tpu_torch.cli.main import main
from rs_bann_tpu_torch.io import BedVM as TBedVM
from rs_bann_tpu_torch.io import ExternalGrouping as TGrouping
from rs_bann_tpu_torch.io.genotypes import CompressedGenotypes as TGenotypes
from rs_bann_tpu_torch.models.net import Net

G, M, N_TRAIN, N_TEST = 3, 10, 400, 150
ACTS = ["identity", "relu", "leaky_relu", "tanh", "silu"]


def run_cli(*argv, cli=main):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli([str(a) for a in argv])
    return buf.getvalue()


def close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for stem, n, seed in [("train", N_TRAIN, 1), ("test", N_TEST, 2)]:
        BedVM.random(n, G * M, seed=seed).to_file(d / stem)
        Phenotypes(rng.standard_normal(n).astype(np.float32)).to_file(d / f"{stem}.phen")
    UniformGrouping(G, M).to_file(d / "train")
    return d


def _jax_sample(path, act, depth, model_type="ridge_ard", seed=4):
    arch = JNetArch.uniform(G, M, 6, depth, 5, activation=act)
    state, _ = j_init_net(arch, model_type, JInitCfg(seed=seed))
    JN.Net(model_type, arch, JD.Hyperparameters(), state).save(str(path))
    return str(path)


LAYOUTS = [("packed", act, depth) for act in ACTS for depth in (0, 1)] + [
    ("dense", "tanh", 1), ("dense", "relu", 0), ("feat-major", "silu", 1)]


@pytest.mark.parametrize("layout,act,depth", LAYOUTS, ids=lambda v: str(v))
def test_analysis_methods_match_jax(data, tmp_path, layout, act, depth):
    """branch_r2s, activations, effect_sizes and population_effect_sizes of
    one JAX-saved sample, on the training genotypes, against JAX's."""
    path = _jax_sample(tmp_path / "0.npz", act, depth)
    jnet, tnet = JN.Net.load(path), Net.load(path, "cpu")
    groups = str(data / "train.groups")
    jgen = JGenotypes(BedVM.from_file(data / "train"), ExternalGrouping.from_file(groups))
    tgen = TGenotypes(TBedVM.from_file(data / "train"), TGrouping.from_file(groups))
    load = {"packed": "to_packed", "dense": "to_stacked", "feat-major": "to_feature_major"}[layout]
    jX = getattr(jgen, load)(jnet.arch).X
    tX = getattr(tgen, load)(tnet.arch, "cpu").X
    y = Phenotypes.from_file(data / "train.phen").y
    import jax.numpy as jnp

    close(tnet.branch_r2s(tX, torch.tensor(y)), jnet.branch_r2s(jX, jnp.asarray(y)), "r2")
    tacts, jacts = tnet.activations(tX), jnet.activations(jX)
    assert len(tacts) == len(jacts) == G
    for g in range(G):
        assert len(tacts[g]) == len(jacts[g]) == depth + 2
        for l, (a, b) in enumerate(zip(tacts[g], jacts[g])):
            close(a, b, f"activations {g} {l}")
    close(tnet.effect_sizes(tX), jnet.effect_sizes(jX), "effect sizes")
    pes = tnet.population_effect_sizes(tX)
    assert len(pes) == G * M
    close(pes, jnet.population_effect_sizes(jX), "population effect sizes")


def test_perturb_matches_jax_bit_for_bit(tmp_path):
    path = _jax_sample(tmp_path / "0.npz", "tanh", 1, model_type="lasso_ard")
    jnet = JN.Net.load(path).perturb(0.01, 0.5)
    tnet = Net.load(path, "cpu").perturb(0.01, 0.5)
    from rs_bann_tpu_torch.models import params as P

    for t, j in zip(P.state_leaves(tnet.state), P.state_leaves(jnet.state)):
        assert np.array_equal(t.numpy(), np.asarray(j))
    # None leaves either part as it is; the padded entries stay 0
    base = Net.load(path, "cpu")
    only = Net.load(path, "cpu").perturb(0.01, None)
    assert torch.equal(only.state.precisions.error, base.state.precisions.error)
    pad = base.arch.layer_in_pad(0) > M
    assert not pad or torch.all(only.state.params.weights[0][:, M:] == 0)


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    """A port train-new run (packed, 4 sweeps, burn-in 3, --effect-sizes,
    --trace): samples 3 and 4 and their effect-size CSVs."""
    out = tmp_path_factory.mktemp("runs")
    run = run_cli(
        "train-new", data / "train", data / "train.phen", data / "train.groups", "ridge_ard",
        "tanh", "0", "4", "5", "--fixed-hidden-layer-width", "6", "--burn-in", "3",
        "--packed-genotypes", "--effect-sizes", "--trace", "--seed", "2", "--cpu", "-o", out,
    ).strip().splitlines()[-1]
    return out / run.split("/")[-1]


def _read(kind, path):
    if kind == "branch-r2":
        return np.asarray(list(csv.reader(io.StringIO(path))), np.float64)
    return {p.name: json.loads(p.read_text()) for p in sorted(path.iterdir())}


@pytest.mark.parametrize("cmd", ["branch-r2", "activations", "population-effect-sizes"])
def test_analysis_subcommands_match_jax(data, port_run, tmp_path, cmd):
    """The port's subcommand and JAX's, each on its own copy of the port's
    models directory: the same files, each array within 1e-5 of its
    largest entry."""
    outs = {}
    for name, cli in (("port", main), ("jax", jax_main)):
        models = tmp_path / name / "models"
        shutil.copytree(port_run / "models", models)
        args = ([data / "test", data / "train.groups"] if cmd == "activations"
                else [data / "test", data / "test.phen", data / "train.groups"])
        out = run_cli(cmd, *args, "-m", models, "--packed-genotypes", "--cpu", cli=cli)
        outs[name] = (_read(cmd, out) if cmd == "branch-r2"
                      else _read(cmd, models.parent / cmd.replace("-", "_")))
        if cmd != "branch-r2":
            assert out.strip().splitlines()[-1] == str(models.parent / cmd.replace("-", "_"))
    port, ref = outs["port"], outs["jax"]
    if cmd == "branch-r2":
        assert port.shape == (2, G)
        close(port, ref)
        return
    assert list(port) == list(ref) == ["3.json", "4.json"]
    for f in port:
        if cmd == "population-effect-sizes":
            assert len(port[f]) == G * M
            close(port[f], ref[f], f)
            continue
        assert len(port[f]) == len(ref[f]) == G
        for g in range(G):
            assert len(port[f][g]) == 2
            for a, b in zip(port[f][g], ref[f][g]):
                close(a, b, f"{f} {g}")


def test_effect_sizes_during_training_match_jax(data, port_run):
    """train-new --effect-sizes writes effect_sizes/<ix>_<g> (chain 0's
    input gradients on the training genotypes, n rows of m) for each saved
    sample, as JAX's effect_sizes of that sample gives them."""
    files = sorted(p.name for p in (port_run / "effect_sizes").iterdir())
    assert files == [f"{ix}_{g}" for ix in (3, 4) for g in range(G)]
    gen = JGenotypes(BedVM.from_file(data / "train"),
                     ExternalGrouping.from_file(str(data / "train.groups")))
    for ix in (3, 4):
        jnet = JN.Net.load(str(port_run / "models" / f"{ix}.npz"))
        es = np.asarray(jnet.effect_sizes(gen.to_packed(jnet.arch).X))
        for g in range(G):
            got = np.loadtxt(port_run / "effect_sizes" / f"{ix}_{g}", delimiter=",")
            close(got, es[g][:, :M], f"{ix}_{g}")


def test_analyze_matches_jax(data, tmp_path):
    """analyze on a port run with a trace and ss_markers' inclusion_probs,
    and a simulation directory's model.params: the JAX package's JSON."""
    out = tmp_path / "runs"
    run = out / run_cli(
        "train-new", data / "train", data / "train.phen", data / "train.groups", "ridge_ard",
        "identity", "0", "6", "5", "--fixed-hidden-layer-width", "4", "--packed-genotypes",
        "--update-mode", "hybrid", "--num-chains", "2", "--burn-in", "2", "--ss-markers",
        "--ssm-fixed-pi", "--ssm-pi", "0.3", "--trace", "--seed", "5", "--cpu", "-o", out,
    ).strip().splitlines()[-1].split("/")[-1]
    sim = tmp_path / "sim"
    sim.mkdir()
    first = json.loads((run / "trace").read_text().splitlines()[0])
    rng = np.random.default_rng(3)
    truth = [{"params": {k: [(np.asarray(v) + rng.normal(0, 0.1, len(v))).tolist()
                             for v in b["params"][k]] for k in ("weights", "biases")}}
             for b in first]
    (sim / "model.params").write_text(json.dumps(truth))
    for extra in ([], ["--sim", sim, "--burn-in", "1"]):
        port = json.loads(run_cli("analyze", run, *extra))
        ref = json.loads(run_cli("analyze", run, *extra, cli=jax_main))
        assert port == ref
    assert {"marker_inclusion_pi", "markers_pip_gt_half", "median_param_ess_per_branch",
            "posterior_mean_vs_truth"} <= set(port)


def test_train_from_a_jax_sample_then_jax_reads_its_samples(data, tmp_path):
    """train from a JAX-saved sample, perturbed: JAX's run directory name,
    and JAX loads and predicts the port's samples as the port does."""
    path = _jax_sample(tmp_path / "7.npz", "identity", 0)
    out = tmp_path / "runs"
    run = run_cli("train", data / "train", data / "train.phen", data / "train.groups",
                  "ridge_ard", path, "2", "5", "--perturb-params", "0.01", "--burn-in", "1",
                  "--packed-genotypes", "--update-mode", "hybrid", "--cpu", "-o", out)
    run = out / run.strip().splitlines()[-1].split("/")[-1]
    assert run.name == "7_cl2_il5_izmailov_st1.0_dtheta0.01_dlambda0.0_rep1"
    assert json.loads((run / "args.json").read_text())["model_file"] == path
    names = sorted(p.name for p in (run / "models").iterdir())
    assert names == ["1.npz", "2.npz"]
    rows = np.asarray(list(csv.reader(io.StringIO(run_cli(
        "predict", data / "test", data / "train.groups", "-m", run / "models",
        "--packed-genotypes", "--cpu")))), np.float64)
    gen = JGenotypes(BedVM.from_file(data / "test"),
                     ExternalGrouping.from_file(str(data / "train.groups")))
    for i, name in enumerate(names):
        jnet = JN.Net.load(str(run / "models" / name))
        close(rows[i], np.asarray(jnet.predict(gen.to_packed(jnet.arch).X)), name)
