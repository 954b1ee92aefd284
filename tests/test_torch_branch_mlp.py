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
