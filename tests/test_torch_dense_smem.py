"""The shared-memory rules of the dense kernels K6, K7 and K8
(``traj_dense_smem``, ``vg_chains_smem``, ``vg_dense_smem`` in
rs_bann_tpu_torch/ops/branch_mlp.py, mirrors of the CUDA entry points of
the same names) against the one rule the three shared before, kept here as
a literal: every shape that rule admitted, each new rule admits, and the
CLI does not refuse. The card tests hold the mirrors to the entry points
(tests/test_torch_cuda_kernels.py ``test_dense_limits_agree_with_the_kernels``).
"""

import itertools
from types import SimpleNamespace

import pytest

from rs_bann_tpu_torch.ops import branch_mlp as BM


def old_dense_chains_smem(m: int, k0: int, s: int, depth: int) -> int:
    """The rule K6, K7 and K8 shared until each had its own: the shared
    memory of K7's first kernel (128-individual tiles, rows of 132 floats),
    or -1 (depth above 1, a width above 32, or more than 227 KB)."""
    w = max(k0, s)
    km = next((k for k in (8, 16, 32) if w <= k), -1)
    if km < 0 or depth not in (0, 1) or m <= 0:
        return -1
    floats = m * 132 + 3 * km * 132 + m * km + 2 * km * km + 4 * km + 128
    return 4 * floats if 4 * floats <= 232448 else -1


WIDTHS = list(itertools.product((8, 16, 32), repeat=2))
RULES = ("traj_dense_smem", "vg_chains_smem", "vg_dense_smem")


def _old_limit(k0, s, depth):
    m = 1
    while old_dense_chains_smem(m + 1, k0, s, depth) > 0:
        m += 1
    return m


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("depth", [0, 1])
def test_each_rule_admits_every_shape_the_old_rule_admitted(rule, depth):
    """Depth 0 and 1, widths 8/16/32 for k0 and s, every m_pad from 1 to the
    old rule's largest: no shape that ran before is refused."""
    fn = getattr(BM, rule)
    for k0, s in WIDTHS:
        top = _old_limit(k0, s, depth)
        assert top >= 263  # the old limits: 263 (width 32), 345 (16), 390 (8)
        for m in range(1, top + 1):
            assert old_dense_chains_smem(m, k0, s, depth) > 0
            assert 0 < fn(m, k0, s, depth) <= 232448, (rule, m, k0, s, depth)


@pytest.mark.parametrize("rule", RULES)
def test_each_rule_refuses_what_no_kernel_runs(rule):
    fn = getattr(BM, rule)
    assert fn(64, 72, 32, 1) < 0  # a width above 64
    assert fn(104, 64, 64, 4) < 0  # depth 4 at width 64: past shared memory
    assert fn(0, 8, 8, 0) < 0
    assert fn(10_000, 8, 8, 0) < 0  # more than 227 KB


def test_the_rules_count_what_the_kernels_carve():
    """At the dense flagship's branch (m_pad 64, widths 32, depth 1) the
    value-and-gradient group (csrc/dense_vg_mma.cuh ``group_floats``):
    fragments 4,096 floats (W0, hi and lo) + 4,096 (W1 twice), planes 3 x
    1,280, accumulators (64 + 32) x 40, vectors and small sums 480; one X
    tile 64 x 40; K7's and K8's err^2 8 floats more than K6's."""
    group = 4096 + 4096 + 3 * 1280 + 96 * 40 + 480
    assert BM.traj_dense_smem(64, 32, 32, 1) == 4 * (64 * 40 + group)
    assert BM.vg_chains_smem(64, 32, 32, 1) == BM.vg_dense_smem(64, 32, 32, 1)
    assert BM.vg_chains_smem(64, 32, 32, 1) == BM.traj_dense_smem(64, 32, 32, 1) + 32


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("depth", [0, 1])
def test_the_cli_takes_every_shape_the_old_rule_admitted(monkeypatch, folded, depth):
    """``_beyond_kernels`` on a CUDA device (feature-major, folded or not)
    refuses no shape the old rule admitted, and refuses a width above 64."""
    from rs_bann_tpu_torch.cli import main as M
    from rs_bann_tpu_torch.models import net

    monkeypatch.setattr(net, "chain_fold_eligible", lambda *a: folded)
    args = SimpleNamespace(feat_major=True, packed_genotypes=False, model_type="ridge_base",
                           activation_function="tanh")
    cfg = SimpleNamespace(gradient_descent=False, ss_markers=False, joint_hmc=False,
                          gradient_descent_joint=False)
    dev = SimpleNamespace(type="cuda")

    def arch(m, k0, s):
        return SimpleNamespace(m_pad=m, depth=depth, s_pad=s, layer_out_pad=lambda l: k0)

    for k0, s in WIDTHS:
        top = _old_limit(k0, s, depth)
        for m in (1, 64, top):
            assert M._beyond_kernels(args, cfg, arch(m, k0, s), dev) == [], (m, k0, s)
    assert M._beyond_kernels(args, cfg, arch(64, 72, 32), dev)
