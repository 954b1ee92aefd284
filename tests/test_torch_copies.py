"""The port's own copies of the JAX package's plain-Python modules against the
originals: ``MCMCCfg`` (fields and defaults), ``NetArch`` (padded sizes and
counts), the groupings and .bed/.phen readers (the same files read the same),
the ``train-new`` / ``train`` / ``predict`` / ``gradients`` / ``branch-r2`` /
``activations`` / ``population-effect-sizes`` / ``analyze`` parsers (the same
flags with the same defaults), so ``args.json`` and model files mean the same
to both packages, and ``analyze``'s loaders and summaries (rs_bann_tpu_torch/
vis.py) on one trace.

``port`` builds the port's NetArch or MCMCCfg from a JAX one's fields; the
other tests use it wherever they hand a JAX object's settings to the port.
"""

import dataclasses
import json

import numpy as np
import pytest

from rs_bann_tpu.cli import main as JCLI
from rs_bann_tpu.group.grouping import ExternalGrouping as JExternal
from rs_bann_tpu.group.grouping import UniformGrouping as JUniform
from rs_bann_tpu.io.bed import BedVM as JBedVM
from rs_bann_tpu.io.phen import Phenotypes as JPhenotypes
from rs_bann_tpu.models.arch import NetArch as JNetArch
from rs_bann_tpu.samplers.mcmc_cfg import MCMCCfg as JMCMCCfg
from rs_bann_tpu_torch.cli import main as TCLI
from rs_bann_tpu_torch.io import BedVM, ExternalGrouping, Phenotypes, UniformGrouping
from rs_bann_tpu_torch.models.arch import NetArch
from rs_bann_tpu_torch.samplers.mcmc_cfg import MCMCCfg


def port(obj):
    """The port's NetArch or MCMCCfg with the fields of a JAX one."""
    cls = {JNetArch: NetArch, JMCMCCfg: MCMCCfg}[type(obj)]
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def test_mcmc_cfg_fields_and_defaults_match():
    tf = [(f.name, f.default) for f in dataclasses.fields(MCMCCfg)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JMCMCCfg)]
    assert tf == jf
    for kw in ({}, {"chain_length": 7}, {"spike_slab": True, "burn_in": 6},
               {"update_mode": "parallel", "num_chains": 4}):
        assert dataclasses.asdict(MCMCCfg(**kw)) == dataclasses.asdict(JMCMCCfg(**kw))
    assert port(JMCMCCfg(update_mode="hybrid", block_size=3)) == MCMCCfg(
        update_mode="hybrid", block_size=3)
    with pytest.raises(ValueError):
        MCMCCfg(update_mode="blocked")


@pytest.mark.parametrize("args", [(5, 20, 8, 0), (3, 13, 6, 1, 5), (64, 64, 32, 1, 32, "tanh", 16)])
def test_net_arch_sizes_and_counts_match(args):
    t, j = NetArch.uniform(*args), JNetArch.uniform(*args)
    for name in ("num_branches", "num_layers", "m_pad", "h_pad", "s_pad", "total_output_weights"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.num_params() == j.num_params()
    for l in range(t.num_layers):
        assert (t.layer_in_pad(l), t.layer_out_pad(l)) == (j.layer_in_pad(l), j.layer_out_pad(l))
    for a, b in zip(t.layer_in_counts() + t.layer_out_counts(),
                    j.layer_in_counts() + j.layer_out_counts()):
        np.testing.assert_array_equal(a, b)
    rules = ([10, 7, 12], 1, ("fraction_of_input", 0.5), ("fraction_of_hidden", 1.0))
    assert dataclasses.asdict(NetArch.from_width_rules(*rules)) == dataclasses.asdict(
        JNetArch.from_width_rules(*rules))
    assert port(j) == t


def test_bed_phen_and_groupings_read_the_same_files(tmp_path):
    bed = JBedVM.random(301, 12, seed=4)
    bed.to_file(tmp_path / "x")
    JPhenotypes(np.arange(301, dtype=np.float32)).to_file(tmp_path / "x.phen")
    JUniform(3, 4).to_file(tmp_path / "x")
    t = BedVM.from_file(tmp_path / "x")
    np.testing.assert_array_equal(t.data, bed.data)
    np.testing.assert_array_equal(t.get_cols([0, 5, 11]), bed.get_cols([0, 5, 11]))
    np.testing.assert_allclose(t.col_means, bed.col_means, rtol=1e-6)
    np.testing.assert_allclose(t.col_stds, bed.col_stds, rtol=1e-6)
    np.testing.assert_allclose(t.get_submatrix_standardized([1, 2]),
                               bed.get_submatrix_standardized([1, 2]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(Phenotypes.from_file(tmp_path / "x.phen").y,
                                  JPhenotypes.from_file(tmp_path / "x.phen").y)
    assert ExternalGrouping.from_file(tmp_path / "x.groups").groups == JExternal.from_file(
        tmp_path / "x.groups").groups == UniformGrouping(3, 4).groups
    # and the port writes what the JAX package reads
    BedVM.random(55, 3, seed=1).to_file(tmp_path / "y")
    np.testing.assert_array_equal(JBedVM.from_file(tmp_path / "y").data,
                                  BedVM.random(55, 3, seed=1).data)


def _flags(parser, cmd):
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs)
            for a in sub.choices[cmd]._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", ["train-new", "train", "predict", "gradients", "branch-r2",
                                 "activations", "population-effect-sizes", "analyze"])
def test_cli_parsers_take_the_same_flags_with_the_same_defaults(cmd):
    assert _flags(TCLI.build_parser(), cmd) == _flags(JCLI.build_parser(), cmd)


def test_vis_copies_give_the_same_summaries(tmp_path):
    """The port's vis.py against the JAX package's on one run directory: the
    statistics, the trace, its parameter matrices, their ESS, the true
    params and the posterior mean against them."""
    from rs_bann_tpu import vis as JV
    from rs_bann_tpu_torch import vis as TV

    rng = np.random.default_rng(6)
    trace = [[{"params": {"weights": [rng.normal(size=6).tolist(), rng.normal(size=2).tolist()],
                          "biases": [rng.normal(size=2).tolist()]}} for _ in range(2)]
             for _ in range(40)]
    (tmp_path / "trace").write_text("\n".join(json.dumps(t) for t in trace) + "\n\n")
    (tmp_path / "training_stats").write_text(json.dumps({"mse_train": [1.0, 0.5]}))
    (tmp_path / "model.params").write_text(json.dumps(trace[3]))
    assert TV.load_training_stats(tmp_path) == JV.load_training_stats(tmp_path)
    tr = TV.load_trace(tmp_path)
    assert tr == JV.load_trace(tmp_path) and len(tr) == 40
    assert TV.load_true_params(tmp_path) == JV.load_true_params(tmp_path)
    for g in range(2):
        m = TV.trace_param_matrix(tr, g)
        np.testing.assert_array_equal(m, JV.trace_param_matrix(tr, g))
        np.testing.assert_array_equal(TV.ess_per_param(m[5:]), JV.ess_per_param(m[5:]))
    np.testing.assert_array_equal(TV.ess_per_param(np.ones((9, 2))), [9.0, 9.0])
    assert TV.posterior_mean_vs_truth(tr, trace[3], 10) == JV.posterior_mean_vs_truth(
        tr, trace[3], 10)
