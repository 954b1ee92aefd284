"""The dense kernels' new shapes on the CPU: depth above 1 and padded widths
up to 64 (the JAX CLI's default width rule gives h = s = 50, padded 56, at
a group of 100 markers), against the JAX package.

The port's plain versions of K6, K7 and K8 (which its kernels are held to
on the card, csrc/dense_deep.cuh at these shapes) run the shapes the card
now takes; the JAX package runs its Pallas kernels in interpret mode
(f32), as its own tests run them. The same numpy inputs go through both.

1. ``data_vg`` (K8a) and ``data_vg_blocked`` (K8b, through an index)
   against JAX's ``data_vg``, unvmapped and under ``jax.vmap``; y_pred and
   rss rtol 1e-5, atol 2e-5, every gradient within 1e-4 of its largest
   entry (sums over n in another order).
2. ``data_vg_chains`` (K7) against JAX's ``data_vg_chains(f32=True)`` and
   ``forward_chains`` against its y_pred: 1e-5 of max(1, each array's
   largest entry).
3. ``integrate_chains`` (K6) at L = 1 and 3 against JAX's
   ``integrate_chains(interpret=True)``: rtol 1e-4 with atol 3e-5 (JAX's
   own tolerance for its kernel against autodiff; L steps compound).
4. ``train-new --feat-major`` at depth 2 and the default width rule, the
   folded schedule, on --cpu: the JAX package predicts its samples as the
   port does (rtol 1e-5).
5. The CLI's refusal rule on a (faked) CUDA device takes the genome-scale
   branch at the default widths on --feat-major under every schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops import leapfrog as JL
from rs_bann_tpu_torch.ops import branch_mlp as TBM
from rs_bann_tpu_torch.ops import leapfrog as TL
from test_torch_cli import _predict_matches_jax, _train_args, data, run_cli  # noqa: F401

M, M_PAD, N = 20, 24, 700

# depth, hidden width h, summary width s, activation: depth 2 and 3, the
# padded widths 40 and 56, tanh and identity
CASES = [(2, 56, 56, "tanh"), (3, 40, 40, "identity"), (2, 40, 24, "identity"),
         (3, 16, 8, "tanh")]


@pytest.fixture(autouse=True)
def _interpret():
    JBM.FORCE = "interpret"
    try:
        yield
    finally:
        JBM.FORCE = None


def T(a):
    return tuple(map(torch.from_numpy, a)) if isinstance(a, tuple) else torch.from_numpy(a)


def J(a):
    return tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)


def _branches(rng, lead, depth, h, s, scale=0.7):
    """Weights [*lead, in, out] and biases [*lead, out] of depth hidden
    layers of width h and a summary layer of width s, scaled by fan-in."""
    outs = [h] * depth + [s, 1]
    dims = list(zip([M_PAD] + outs[:-1], outs))
    ws = tuple((rng.standard_normal(lead + d) * scale / np.sqrt(d[0])).astype(np.float32)
               for d in dims)
    bs = tuple((rng.standard_normal(lead + (d[1],)) * 0.1).astype(np.float32) for d in dims[:-1])
    return ws, bs


def _x(rng, lead):
    """Feature-major X [..., M_PAD, N]; the padded marker rows are zero."""
    x = np.zeros(lead + (M_PAD, N), np.float32)
    x[..., :M, :] = rng.standard_normal(lead + (M, N))
    return x


def _close(t, j, rtol=1e-5, atol=2e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _close_grads(tgrads, jgrads):
    assert len(tgrads) == len(jgrads)
    for a, b in zip(tgrads, jgrads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(b)).max()))


# ------------------------------------------------- 1. K8a and K8b


@pytest.mark.parametrize("depth,h,s,act", CASES, ids=lambda a: str(a))
def test_data_vg_and_blocked_match_jax_at_the_new_shapes(depth, h, s, act):
    rng = np.random.default_rng(depth * 100 + h + s)
    ws, bs = _branches(rng, (), depth, h, s)
    xT, target = _x(rng, ()), rng.standard_normal(N).astype(np.float32)
    jy, jrss, jdws, jdbs = JBM.data_vg(act, J(xT), J(ws), J(bs), J(target))
    ty, trss, tdws, tdbs = TBM.data_vg(act, T(xT), T(ws), T(bs), T(target))
    _close(ty, jy)
    _close(trss, jrss)
    assert len(tdws) == depth + 2 and len(tdbs) == depth + 1
    _close_grads(tdws + tdbs, tuple(jdws) + tuple(jdbs))
    assert np.all(tdws[0].numpy()[M:] == 0)  # padded marker rows never move

    # K8b: 5 instances on X of 3 branches through an index with repeats
    ws, bs = _branches(rng, (5,), depth, h, s)
    X = _x(rng, (3,))
    ix = np.array([2, 0, 2, 1, 0], np.int32)
    targets = rng.standard_normal((5, N)).astype(np.float32)
    jout = jax.vmap(lambda x, w, b, t: JBM.data_vg(act, x, w, b, t))(
        J(X[ix]), J(ws), J(bs), J(targets))
    tout = TBM.data_vg_blocked(act, T(X), T(ix), T(ws), T(bs), T(targets))
    _close(tout[0], jout[0])
    _close(tout[1], jout[1])
    _close_grads(tout[2] + tout[3], tuple(jout[2]) + tuple(jout[3]))
    np.testing.assert_array_equal(TBM.forward_blocked(act, T(X), T(ix), T(ws), T(bs)).numpy(),
                                  tout[0].numpy())


# ------------------------------------------------- 2. K7, both instantiations


@pytest.mark.parametrize("depth,h,s,act", CASES, ids=lambda a: str(a))
def test_data_vg_chains_and_forward_match_jax_at_the_new_shapes(depth, h, s, act):
    rng = np.random.default_rng(depth * 10 + h + s)
    G, C = 2, 3
    ws, bs = _branches(rng, (G, C), depth, h, s)
    xT = _x(rng, (G,))
    target = rng.standard_normal((G, C, N)).astype(np.float32)
    jout = JBM.data_vg_chains(act, J(xT), J(ws), J(bs), J(target), f32=True)
    tout = TBM.data_vg_chains(act, T(xT), T(ws), T(bs), T(target))
    flat = lambda o: [o[0], o[1], *o[2], *o[3]]  # noqa: E731
    assert len(flat(tout)) == len(flat(jout)) == 2 + 2 * depth + 3
    for t, j in zip(flat(tout), flat(jout)):
        assert t.shape == j.shape
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(TBM.forward_chains(act, T(xT), T(ws), T(bs)).numpy(),
                                  tout[0].numpy())


# ------------------------------------------------- 3. K6


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("depth,h,s,act,l1", [(2, 56, 56, "tanh", False),
                                              (3, 40, 24, "identity", True)],
                         ids=lambda a: str(a))
def test_integrate_chains_matches_jax_at_the_new_shapes(depth, h, s, act, l1, steps):
    rng = np.random.default_rng(7 + depth)
    G, C = 2, 2
    ws, bs = _branches(rng, (G, C), depth, h, s)
    p_w, p_b = _branches(rng, (G, C), depth, h, s, scale=1.0)
    e_w, e_b = _branches(rng, (G, C), depth, h, s)
    eps_w = tuple(np.abs(e) * np.float32(5e-3) for e in e_w)
    eps_b = tuple(np.abs(e) * np.float32(5e-2) for e in e_b)
    lam_w = tuple(np.abs(e) + np.float32(0.5) for e in _branches(rng, (G, C), depth, h, s)[0])
    lam_b = tuple(np.zeros_like(b) for b in bs)
    xT = _x(rng, (G,))
    targets = rng.standard_normal((G, C, N)).astype(np.float32)
    err = (rng.random((G, C)) * 0.5 + 0.5).astype(np.float32)
    args = (xT, targets, err, ws, bs, p_w, p_b, eps_w, eps_b, lam_w, lam_b)
    jout = JL.integrate_chains(act, *map(J, args), steps, l1=l1, interpret=True)
    tout = TL.integrate_chains(act, *map(T, args), steps, l1=l1)
    for tpart, jpart in zip(tout, jout):
        assert len(tpart) == len(jpart)
        for t, j in zip(tpart, jpart):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=3e-5)
    assert max(np.abs(t.numpy() - w).max() for t, w in zip(tout[0], ws)) > 0


# ------------------------------------------------- 4. the CLI


def test_feat_major_depth_2_at_the_default_widths_jax_reads_the_samples(data, tmp_path):
    """train-new --feat-major ridge_ard tanh 2 with no fixed width (the JAX
    CLI's default rule: h = s = 5 at 10 markers a group), folded with 2
    chains and the adaptation, on --cpu; every chain's samples are
    predicted by the JAX package as by the port."""
    argv = _train_args(data, tmp_path, "--feat-major", "--update-mode", "parallel",
                       "--num-chains", "2", "--step-size-mode", "dual_averaging",
                       "--mass-adaptation")
    at = argv.index("--fixed-hidden-layer-width")
    del argv[at:at + 2]
    argv[4:7] = ["ridge_ard", "tanh", "2"]
    out = run_cli(*argv)
    run = tmp_path / out.strip().splitlines()[-1].split("/")[-1]
    samples = ["1.npz", "2.npz", "3.npz", "4.npz"]
    for c in range(2):
        _predict_matches_jax(data, run / "models" / f"chain{c}", samples, packed=False)
    from rs_bann_tpu_torch.models.net import Net

    net = Net.load(str(run / "models" / "chain0" / "4.npz"), "cpu")
    assert (net.arch.depth, net.arch.layer_out_pad(0), net.arch.s_pad) == (2, 8, 8)
    assert TBM.dense_deep(8, 8, 2) and TBM.traj_dense_smem(net.arch.m_pad, 8, 8, 2) > 0


FEAT_SLICE_CASES = {  # the genome-scale branch at the default widths, every schedule
    "parallel": (["--update-mode", "parallel", "--num-chains", "4"], 2, "tanh"),
    "folded": (["--update-mode", "hybrid", "--num-chains", "4"], 2, "tanh"),
    "sequential": ([], 2, "tanh"),
    "unfolded": (["--update-mode", "hybrid", "--per-chain-block-perm", "--num-chains", "4"], 2,
                 "tanh"),
    "recipe": (["--update-mode", "hybrid", "--num-chains", "4", "--ss-markers"], 0, "identity"),
}


@pytest.mark.parametrize("case", FEAT_SLICE_CASES)
def test_the_default_widths_are_not_refused_on_cuda_feat_major(data, tmp_path, case):
    """The genome-scale branch (100 markers, padded 104) at the JAX CLI's
    default width rule (h = s = 50, padded 56) on --feat-major: depth 2 on
    K6/K7 (folded) or K8 (sequential, unfolded), and the recipe's identity
    depth 0 with --ss-markers at width 56, are not refused on the card."""
    from rs_bann_tpu_torch.cli import main as cli_main
    from rs_bann_tpu_torch.cli.args import mcmc_cfg_from_args
    from rs_bann_tpu_torch.models import NetArch

    extra, depth, act = FEAT_SLICE_CASES[case]
    argv = _train_args(data, tmp_path, "--feat-major", *extra)
    i = argv.index("--fixed-hidden-layer-width")
    del argv[i : i + 2]
    argv[4:7] = ["ridge_ard", act, str(depth)]
    args = cli_main.build_parser().parse_args([str(a) for a in argv])
    cfg = mcmc_cfg_from_args(args, str(tmp_path))
    arch = NetArch.from_width_rules([100] * 10, depth, ("fraction_of_input", 0.5),
                                    ("fraction_of_hidden", 1.0), activation=act)
    assert (arch.m_pad, arch.layer_out_pad(0), arch.s_pad) == (104, 56, 56)
    assert cli_main._beyond_kernels(args, cfg, arch, torch.device("cuda")) == []
