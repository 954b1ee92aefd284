"""The port's fused packed value-and-gradient (K4, plain PyTorch version)
against the JAX package's ``data_vg_packed`` with its Pallas kernel in
interpret mode (f32 there, as its own tests run it).

Tolerances: y_pred atol 1e-5 (a sum over markers in another order);
rss and every dW / db rtol 1e-4 (sums over n individuals in another order),
with an absolute floor of 1e-4 of the array's largest entry for the entries
whose sums cancel to near 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.ops import branch_mlp as JBM
from rs_bann_tpu.ops.packed_matmul import pack_strided
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.ops import branch_mlp as TBM

M_PAD, N = 24, 700


@pytest.fixture(autouse=True)
def _interpret():
    JBM.FORCE = "interpret"
    try:
        yield
    finally:
        JBM.FORCE = None


def _inputs(depth, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, size=(M_PAD, N)).astype(np.float32)
    vals[20:] = 0  # padded marker rows
    by = pack_strided(vals)
    scale = rng.uniform(0.5, 2.0, M_PAD).astype(np.float32)
    scale[20:] = 0
    shift = rng.uniform(0.0, 2.0, M_PAD).astype(np.float32)
    shift[20:] = 0
    widths = [M_PAD] + ([8] if depth == 1 else []) + [16, 1]
    ws = [(rng.standard_normal((widths[i], widths[i + 1])) * 0.3).astype(np.float32)
          for i in range(len(widths) - 1)]
    bs = [(rng.standard_normal(widths[i + 1]) * 0.1).astype(np.float32)
          for i in range(len(widths) - 2)]
    target = rng.standard_normal(N).astype(np.float32)
    return by, scale, shift, ws, bs, target


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("act", ["identity", "tanh", "silu"])
def test_data_vg_packed_matches_jax(depth, act):
    by, scale, shift, ws, bs, target = _inputs(depth, seed=depth * 10 + len(act))
    jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N)
    jy, jrss, jdws, jdbs = JBM.data_vg_packed(
        act, jx, tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jnp.asarray(target)
    )
    tx = TD.PackedX(torch.from_numpy(by), torch.from_numpy(scale), torch.from_numpy(shift), N)
    ty, trss, tdws, tdbs = TBM.data_vg_packed(
        act, tx, tuple(map(torch.from_numpy, ws)), tuple(map(torch.from_numpy, bs)),
        torch.from_numpy(target),
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(trss), float(jrss), rtol=1e-4)
    assert len(tdws) == len(jdws) and len(tdbs) == len(jdbs)
    for t, j in zip(tdws + tdbs, jdws + jdbs):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4 * np.abs(j).max())
    # padded marker rows get exactly zero gradient, so they never move
    assert np.all(tdws[0].numpy()[20:] == 0)


# (m, k0, s, depth) -> shared memory of K4 and of K5, by hand from the C
# rules. Depth 0 at padded widths up to 32 (csrc/branch_vg_packed.cu and
# csrc/traj_packed.cu smem_bytes0): floats 512 (KM + 4) + m KM + KM + KM +
# 4 KM (K5: + 2 m), times 4, plus the byte tile of m rows of 132 bytes.
# Every other shape (csrc/packed_deep.cuh layout, one chain; KM the width
# class 8, 16, 32 or 64, m16 = m rounded up to 16, ws = m16 where m16 / 16
# is odd, else m16 + 16): 8 256 + 2 m16 16 + 6 KM ws + 4 (2 KM + depth
# (KM^2 + KM)) + 4 (depth + 2) 64 (KM + 4) + 12 KM 34 + 4 (5 64 + 8). -1
# above 232,448 bytes or past width 64
PACKED_LIMITS = [
    ((104, 16, 16, 0), 61728, 62560),  # the main path: width 10 padded to 16
    ((104, 56, 56, 0), 111392, 111392),  # the default width rule at m = 100: h = s = 50
    ((104, 16, 16, 2), 47008, 47008),  # depth 2
    ((975, 16, 16, 0), 232444, -1),
    ((936, 16, 16, 0), 224800, 232288),
    ((976, 16, 16, 0), -1, -1),  # too many markers
    ((23, 32, 32, 1), 58784, 58784),  # depth 1 at width 32, once refused past 23 markers
    ((24, 32, 32, 1), 58784, 58784),
    ((104, 56, 56, 2), 179488, 179488),  # the slice: depth 2 at the default widths
    ((224, 56, 56, 2), 232224, 232224),  # the most markers depth 2 takes there
    ((225, 56, 56, 2), -1, -1),
    ((104, 72, 72, 0), -1, -1),  # a padded width above 64
    ((16, 64, 64, 5), -1, -1),  # depth 5 at width 64: past shared memory
]


# (m, k0, s, depth) -> shared memory of K6 and of K7 and K8 (one rule, but
# for err^2), by hand from the C rules. Depth 0 and 1 at padded widths up
# to 32 (csrc/dense_vg_mma.cuh cta_smem, unchanged; test_torch_dense_smem.py
# counts its parts). Every other shape (csrc/dense_deep.cuh layout, one X
# buffer, the same for the three; KM the width class 8, 16, 32 or 64, m16 =
# m rounded up to 16, ws = KM + 16 at KM = 8, else KM + 8): 4 (72 m16 + ws
# m16 + 2 KM + depth (KM^2 + KM) + (depth + 2) 64 (KM + 4) + 5 64 + 8); at
# the slice's branch (104, 56, 56, 2): 4 (8,064 + 8,064 + 128 + 8,320 +
# 17,408 + 328) = 169,248. -1 above 232,448 bytes or past width 64
DENSE_LIMITS = [
    ((64, 32, 32, 1), 75648, 75680),  # the dense flagship, unchanged
    ((40, 16, 16, 0), 20928, 20960),
    ((104, 16, 16, 1), 56256, 56288),
    ((104, 56, 56, 2), 169248, 169248),  # the slice: depth 2 at the default widths
    ((104, 56, 56, 0), 101152, 101152),  # depth 0 at width 56
    ((104, 40, 40, 2), 169248, 169248),  # width 40: the same class (KM 64)
    ((104, 16, 16, 3), 73312, 73312),
    ((104, 8, 8, 2), 57248, 57248),
    ((24, 40, 24, 1), 89120, 89120),  # depth 1 past width 32
    ((104, 64, 64, 3), 203296, 203296),
    ((16, 64, 64, 5), 216096, 216096),
    ((208, 56, 56, 2), 224544, 224544),  # the most markers depth 2 takes at width 56
    ((209, 56, 56, 2), -1, -1),
    ((104, 64, 64, 4), -1, -1),  # depth 4 at width 64 and 104 markers: past shared memory
    ((104, 72, 72, 0), -1, -1),  # a padded width above 64
]


@pytest.mark.parametrize("shape,k6,k78", DENSE_LIMITS, ids=lambda a: str(a))
def test_dense_kernel_limits(shape, k6, k78):
    """The Python mirrors of K6's, K7's and K8's shared-memory rules, which
    the CLI asks before a feature-major run on the card."""
    assert TBM.traj_dense_smem(*shape) == k6
    assert TBM.vg_chains_smem(*shape) == k78
    assert TBM.vg_dense_smem(*shape) == k78


# The same rules on X stored in bf16 (--x-bf16), by hand: the X tile holds
# bf16, so it takes half its f32 bytes and the rest is unchanged. First
# design: 80 m16 bytes less ([m16][40] x 2 bytes in place of 4), so at
# depth 1 width 32 4 (40 m16 + 64 m8 + 40 m16 + 9,704) - 80 m16 = 240 m16
# + 256 m8 + 38,816 for K7 and K8 (K6: 32 less, no err^2), within 232,448
# up to m = 384 (229,280), where f32 X stops at 330. Deep design: 144 m16
# less ([m16][72]); at depth 2 width 56 (KM 64) 432 m16 + 104,736, so up to
# 288 markers (229,152) where f32 X stops at 208.
DENSE_LIMITS_XBF16 = [
    ((64, 32, 32, 1), 70528, 70560),  # the dense flagship: 5,120 bytes less
    ((40, 16, 16, 0), 17088, 17120),
    ((104, 16, 16, 1), 47296, 47328),
    ((384, 32, 32, 1), 229248, 229280),  # the most markers depth 1 takes at width 32
    ((385, 32, 32, 1), -1, -1),
    ((104, 56, 56, 2), 153120, 153120),  # the slice's branch: 16,128 bytes less
    ((104, 56, 56, 0), 85024, 85024),
    ((208, 56, 56, 2), 194592, 194592),  # the most markers f32 X takes there
    ((288, 56, 56, 2), 229152, 229152),  # the most markers depth 2 takes at width 56
    ((289, 56, 56, 2), -1, -1),
    ((104, 72, 72, 0), -1, -1),  # a padded width above 64
]


@pytest.mark.parametrize("shape,k6,k78", DENSE_LIMITS_XBF16, ids=lambda a: str(a))
def test_dense_kernel_limits_on_bf16_x(shape, k6, k78):
    """The Python mirrors of K6's, K7's and K8's shared-memory rules on bf16
    X (``x_dtype=torch.bfloat16``), which the CLI asks before a
    ``--feat-major --x-bf16`` run on the card."""
    assert TBM.traj_dense_smem(*shape, torch.bfloat16) == k6
    assert TBM.vg_chains_smem(*shape, torch.bfloat16) == k78
    assert TBM.vg_dense_smem(*shape, torch.bfloat16) == k78
    if k78 > 0:  # X in any other dtype is refused
        with pytest.raises(TypeError):
            TBM.vg_dense_smem(*shape, torch.float16)


@pytest.mark.parametrize("shape,k4,k5", PACKED_LIMITS, ids=lambda a: str(a))
def test_packed_kernel_limits(shape, k4, k5):
    """The Python mirrors of K4's and K5's shared-memory rules, which the
    CLI asks before a packed HMC run on the card."""
    assert TBM.branch_vg_packed_smem(*shape) == k4
    assert TBM.traj_packed_smem(*shape) == k5
