"""The port's packed genotype ops (rs_bann_tpu_torch/ops/packed_matmul.py)
against the JAX package's.

The same numpy inputs go through both. JAX runs its jnp reference and its
Pallas kernel in interpret mode; the port runs the plain PyTorch version of
its CUDA kernel K2 (the CPU path of ``packed_linear``). Tolerances: the
packing is exact; ``packed_linear`` sums over markers in another order, so
f32 rtol/atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops import packed_matmul as JPM
from rs_bann_tpu_torch.ops import packed_matmul as TPM

M, N, K = 24, 700, 16  # n deliberately not a multiple of 512


def _genotypes(seed, m=M, n=N):
    return np.random.default_rng(seed).integers(0, 3, size=(m, n)).astype(np.float32)


def test_pack_strided_matches_jax():
    vals = _genotypes(0)
    np.testing.assert_array_equal(TPM.pack_strided(vals), JPM.pack_strided(vals))


@pytest.mark.parametrize("n", [N, 1024, 5])
def test_unpack_strided_matches_jax_and_inverts_pack(n):
    vals = _genotypes(1, n=n)
    by = TPM.pack_strided(vals)
    got = TPM.unpack_strided(torch.from_numpy(by), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(JPM.unpack_strided(jnp.asarray(by), n)))
    np.testing.assert_array_equal(got, vals)
    # individuals past n decode to 0 (missing-code padding)
    full = TPM.unpack_strided(torch.from_numpy(by), by.shape[1] * 4).numpy()
    assert np.all(full[:, n:] == 0)


@pytest.mark.parametrize("act", JPM.FUSED_ACTIVATIONS)
def test_packed_linear_matches_jax(act):
    rng = np.random.default_rng(2)
    G = 3
    by = np.stack([JPM.pack_strided(_genotypes(10 + g)) for g in range(G)])
    a = rng.standard_normal((G, M, K)).astype(np.float32)
    off = rng.standard_normal((G, K)).astype(np.float32)

    got = TPM.packed_linear(torch.from_numpy(by), torch.from_numpy(a), torch.from_numpy(off), N, act)
    assert got.shape == (G, N, K)
    for g in range(G):
        ref = np.asarray(JPM.packed_linear(jnp.asarray(by[g]), jnp.asarray(a[g]), jnp.asarray(off[g]), N, act))
        kern = np.asarray(JPM._pallas_fwd_fused(
            jnp.asarray(by[g]), jnp.asarray(a[g]), jnp.asarray(off[g]), N, act, interpret=True
        ))
        single = TPM.packed_linear(
            torch.from_numpy(by[g]), torch.from_numpy(a[g]), torch.from_numpy(off[g]), N, act
        ).numpy()
        np.testing.assert_allclose(got[g].numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[g].numpy(), kern, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(single, got[g].numpy())


def test_packed_linear_rejects_silu():
    by = torch.from_numpy(TPM.pack_strided(_genotypes(3)))
    with pytest.raises(ValueError, match="not fusable"):
        TPM.packed_linear(by, torch.zeros(M, K), torch.zeros(K), N, "silu")


def test_cpu_path_launches_no_kernel():
    before = TPM.packed_linear.launches
    by = torch.from_numpy(TPM.pack_strided(_genotypes(4)))
    TPM.packed_linear(by, torch.ones(M, K), torch.zeros(K), N, "identity")
    assert TPM.packed_linear.launches == before
