"""The port's checkpoint and resume (rs_bann_tpu_torch/train.py
``save_checkpoint``, ``read_checkpoint``, ``load_checkpoint`` and
``train(checkpoint_interval=, resume_from=)``, the CLI's
``--checkpoint-interval`` / ``--resume``) on the CPU.

1. A resumed run is the uninterrupted one bit for bit: 4 sweeps straight
   against 2 sweeps, a checkpoint and a resume to 4, on the packed
   sequential, folded hybrid (C = 2, dual averaging, mass adaptation and
   ss_markers), per-chain-permutation hybrid and GD-warm-started hybrid
   schedules and the feature-major parallel one: every array of samples 3
   and 4 of every chain, the final carry field by field (the final
   checkpoints, the generator's state included), ``inclusion_probs``, the
   statistics and the trace's lines.
2. A round trip keeps every carry field's dtype, shape and value, the sweep
   counter and the generator; a resume refuses, before anything is
   written, a checkpoint of the JAX package, one whose arrays do not fit
   the new carry, and one whose generator is of another device type.
3. Against the JAX package's CLI on one toy: the resumed run directories
   hold the same sample files, ``training_stats`` the same keys and series
   lengths with the same counts (both carry the acceptance counts through
   the checkpoint), the trace as many lines, and JAX loads the port's
   resumed samples.
"""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from rs_bann_tpu.cli.main import main as jax_main
from rs_bann_tpu.group.grouping import UniformGrouping
from rs_bann_tpu.io.bed import BedVM
from rs_bann_tpu.io.phen import Phenotypes
from rs_bann_tpu.models import net as JN
from rs_bann_tpu_torch.cli.main import main
from rs_bann_tpu_torch.models.arch import NetArch
from rs_bann_tpu_torch.models.init import InitCfg, init_net
from rs_bann_tpu_torch.models.net import Net
from rs_bann_tpu_torch.models import density as D
from rs_bann_tpu_torch.ops.packed_matmul import pack_strided
from rs_bann_tpu_torch import train as TR

G, M, N = 3, 10, 400


def run_cli(*argv, cli=main):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli([str(a) for a in argv])
    return buf.getvalue().strip().splitlines()[-1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for stem, n, seed in [("train", N, 1), ("test", 150, 2)]:
        BedVM.random(n, G * M, seed=seed).to_file(d / stem)
        Phenotypes(rng.standard_normal(n).astype(np.float32)).to_file(d / f"{stem}.phen")
    UniformGrouping(G, M).to_file(d / "train")
    return d


def _args(d, chain_length, *extra, model=("ridge_ard", "identity", "0")):
    return ["train-new", d / "train", d / "train.phen", d / "train.groups", *model,
            chain_length, "5", "--fixed-hidden-layer-width", "4", "--burn-in", "1",
            "--bfile-test", d / "test", "--p-test", d / "test.phen", "--seed", "3", "--trace",
            "--cpu", *extra]


ADAPT = ["--step-size-mode", "dual_averaging", "--mass-adaptation", "--burn-in", "3"]
SSM = ["--ss-markers", "--ssm-fixed-pi", "--ssm-pi", "0.2", "--ssm-warmup", "1"]
SCHEDULES = {
    "packed-sequential": ["--packed-genotypes"],
    "packed-hybrid-folded-adapted-ssm": ["--packed-genotypes", "--update-mode", "hybrid",
                                         "--num-chains", "2", *ADAPT, *SSM],
    "packed-hybrid-per-chain-perm": ["--packed-genotypes", "--update-mode", "hybrid",
                                     "--num-chains", "2", "--per-chain-block-perm"],
    "feat-major-parallel-folded": ["--feat-major", "--update-mode", "parallel",
                                   "--num-chains", "2", "--fixed-summary-layer-width", "4"],
    "packed-gd-warmup-hybrid": ["--packed-genotypes", "--gd-warmup", "1", "--update-mode",
                                "hybrid", "--num-chains", "2"],
}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert np.array_equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_resume_equals_the_uninterrupted_run_bit_for_bit(data, tmp_path, schedule):
    extra = SCHEDULES[schedule]
    model = ("ridge_base", "tanh", "1") if "--feat-major" in extra else ("ridge_ard", "identity",
                                                                        "0")
    straight = tmp_path / run_cli(*_args(data, 4, *extra, "--checkpoint-interval", "2",
                                         "-o", tmp_path / "a", model=model))
    cut = tmp_path / run_cli(*_args(data, 2, *extra, "--checkpoint-interval", "2",
                                    "-o", tmp_path / "b", model=model))
    resumed = tmp_path / run_cli(*_args(data, 4, *extra, "--checkpoint-interval", "2",
                                        "--resume", cut / "checkpoint.npz", "-o", tmp_path / "c",
                                        model=model))
    chains = ["."] if "--num-chains" not in extra else ["chain0", "chain1"]
    for c in chains:
        names = sorted(p.name for p in (resumed / "models" / c).iterdir())
        assert names == ["3.npz", "4.npz"]
        for name in names:
            _assert_same_arrays(_npz(straight / "models" / c / name),
                                _npz(resumed / "models" / c / name), f"{c}/{name}")
    # the final carry, field by field, the generator and the sweep counter too
    final, again = _npz(straight / "checkpoint.npz"), _npz(resumed / "checkpoint.npz")
    _assert_same_arrays(final, again, "the final checkpoint")
    assert int(final["sweeps"]) == 4
    assert json.loads(bytes(final["meta_json"]))["chain_ix"] == 4
    a, r = (json.loads((run / "training_stats").read_text()) for run in (straight, resumed))
    assert a == r
    assert len(a["mse_train"]) == 5
    trace = (straight / "trace").read_text().splitlines()
    assert (resumed / "trace").read_text().splitlines() == trace[3:]
    if "--ss-markers" in extra:
        assert (straight / "inclusion_probs").read_text() == (
            resumed / "inclusion_probs").read_text()


def _toy_carry(chains=2, mass=True, ssm=True):
    arch = NetArch.uniform(G, M, 4, 0, activation="identity")
    state, _ = init_net(arch, "ridge_ard", InitCfg(seed=1), device="cpu")
    net = Net("ridge_ard", arch, D.Hyperparameters(), state)
    rng = np.random.default_rng(2)
    by = np.stack([pack_strided(rng.integers(0, 3, (arch.m_pad, N)).astype(np.float32))
                   for _ in range(G)])
    X = D.PackedX(torch.from_numpy(by), torch.rand(G, arch.m_pad) + 0.5,
                  torch.rand(G, arch.m_pad), N)
    y = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    return net, net.init_carry(X, y, chains=chains, step_size_factor=0.3, mass_adaptation=mass,
                               ss_markers=ssm, ssm_pi=0.2)


def test_checkpoint_round_trip_keeps_every_field_and_the_generator(tmp_path):
    net, carry = _toy_carry()
    # every field off its initial value, the int64 counts and the sweep counter too
    gen = torch.Generator().manual_seed(5)
    for _, t in TR._named(carry):
        t.copy_(torch.randint(0, 7, t.shape, generator=gen) if not t.is_floating_point()
                else torch.randn(t.shape, generator=gen))
    carry = carry._replace(sweeps=7)
    torch.rand(13, generator=gen)
    stats = TR.TrainingStats()
    stats.mse_train, stats.mse_test, stats.lpd = [1.5, 0.25], None, [-3.0, -2.5]
    size = TR.save_checkpoint(tmp_path / "checkpoint.npz", carry, 2, stats, gen)
    assert size == (tmp_path / "checkpoint.npz").stat().st_size
    assert not (tmp_path / "checkpoint.npz.partial").exists()
    names = dict(TR._named(carry))
    assert {"state.params.weights.0", "state.precisions.error", "residual", "counts",
            "mm_m2", "ssm_pip"} <= set(names)

    _, fresh = _toy_carry()
    gen2 = torch.Generator().manual_seed(99)
    back, chain_ix, saved = TR.load_checkpoint(tmp_path / "checkpoint.npz", fresh, gen2)
    assert chain_ix == 2 and back.sweeps == 7
    assert saved == {"mse_train": [1.5, 0.25], "mse_test": None, "lpd": [-3.0, -2.5]}
    for name, t in TR._named(back):
        assert t.dtype == names[name].dtype and t.shape == names[name].shape, name
        assert torch.equal(t, names[name]), name
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert torch.equal(torch.rand(5, generator=gen2), torch.rand(5, generator=gen))


def _rewrite(path, out, **changes):
    z = _npz(path)
    meta = json.loads(bytes(z["meta_json"]))
    meta.update(changes)
    z["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(out, **z)


@pytest.mark.parametrize("case", ["jax", "shapes", "device"])
def test_resume_refuses_a_checkpoint_that_does_not_fit(data, tmp_path, case):
    """Each refusal names the mismatch and comes before anything is
    written. The JAX package's checkpoint is written by its own
    ``save_checkpoint``."""
    from rs_bann_tpu.train import TrainingStats as JStats
    from rs_bann_tpu.train import save_checkpoint as j_save
    import jax

    hybrid = ["--packed-genotypes", "--update-mode", "hybrid", "--num-chains", "2"]
    ckpt = tmp_path / "checkpoint.npz"
    if case == "jax":
        j_save(ckpt, {"residual": np.zeros((2, N), np.float32), "key": jax.random.key(0)}, 2,
               JStats())
        want = "checkpoint of the JAX package"
    else:
        run = tmp_path / run_cli(*_args(data, 2, *hybrid, "--checkpoint-interval", "2",
                                        "-o", tmp_path / "b"))
        if case == "shapes":  # resumed with one chain more: [3, ...] against [2, ...]
            ckpt, hybrid = run / "checkpoint.npz", hybrid[:-1] + ["3"]
            want = "does not match this run's carry: state.params.weights.0"
        else:
            _rewrite(run / "checkpoint.npz", ckpt, generator_device="cuda")
            want = "holds a cuda generator's state; this run draws on cpu"
    out = tmp_path / "c"
    with pytest.raises(SystemExit) as e:
        run_cli(*_args(data, 4, *hybrid, "--resume", ckpt, "-o", out))
    assert want in str(e.value.code) and "--resume" in str(e.value.code)
    assert not out.exists()


def test_resume_matches_the_jax_package_s_cli(data, tmp_path):
    """The JAX CLI and the port's, each run 2 sweeps with a checkpoint and
    resumed to 4: the same sample files, statistics keys, series lengths
    and counts (the carry holds them in both, so the resumed run counts
    all 4 sweeps), trace lines; JAX reads the port's resumed samples."""
    extra = ["--packed-genotypes", "--checkpoint-interval", "1"]
    runs = {}
    for name, cli in (("port", main), ("jax", jax_main)):
        cut = tmp_path / run_cli(*_args(data, 2, *extra, "-o", tmp_path / name / "b"), cli=cli)
        runs[name] = tmp_path / run_cli(*_args(data, 4, *extra, "--resume",
                                               cut / "checkpoint.npz",
                                               "-o", tmp_path / name / "c"), cli=cli)
    port, jax_run = runs["port"], runs["jax"]
    assert port.name == jax_run.name
    names = sorted(p.name for p in (port / "models").iterdir())
    assert names == sorted(p.name for p in (jax_run / "models").iterdir()) == ["3.npz", "4.npz"]
    ps, js = (json.loads((r / "training_stats").read_text()) for r in (port, jax_run))
    assert sorted(ps) == sorted(js)
    for k in ("mse_train", "mse_test", "lpd"):
        assert len(ps[k]) == len(js[k]) == 5
    assert ps["num_samples"] == js["num_samples"] == 4 * G
    for r in (port, jax_run):
        assert len((r / "trace").read_text().splitlines()) == 2
        assert sorted(p.name for p in r.iterdir()) == [
            "args.json", "checkpoint.npz", "hyperparams", "models", "trace", "training_stats"]
    for name in names:
        j = JN.Net.load(str(port / "models" / name))
        t = Net.load(str(port / "models" / name), "cpu")
        np.testing.assert_array_equal(np.asarray(j.state.params.weights[0]),
                                      t.state.params.weights[0].numpy())
