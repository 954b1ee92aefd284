"""The port's packed genotype ops (rs_bann_tpu_torch/ops/packed_matmul.py)
against the JAX package's.

The same numpy inputs go through both. JAX runs its jnp reference and its
Pallas kernels in interpret mode; the port runs the plain PyTorch versions
of its CUDA kernels K2, K9a, K3 and K9b (the CPU paths of
``packed_linear``, ``packed_matmul`` and their VJPs), and autograd through
the port's packed layer 0 is held against ``jax.vjp`` of JAX's forward.
Tolerances: the packing is exact; the products sum over markers or
individuals in another order, so f32 rtol/atol 1e-5. The backward tests
scale their cotangents by 0.1, so the sums over 700 individuals stay O(1)
to O(10), where atol 1e-5 sits above their f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.models import density as JD
from rs_bann_tpu.ops import packed_matmul as JPM
from rs_bann_tpu_torch.models import density as TD
from rs_bann_tpu_torch.ops import packed_matmul as TPM

M, N, K = 24, 700, 16  # n deliberately not a multiple of 512


def _genotypes(seed, m=M, n=N):
    return np.random.default_rng(seed).integers(0, 3, size=(m, n)).astype(np.float32)


def test_pack_strided_matches_jax():
    vals = _genotypes(0)
    np.testing.assert_array_equal(TPM.pack_strided(vals), JPM.pack_strided(vals))


@pytest.mark.parametrize("n", [N, 1024, 5, 513])
def test_strided_from_bed_is_pack_strided_of_the_decoded_genotypes(n):
    """The bed's bytes moved into the group-strided layout as codes are
    pack_strided's bytes of the decoded genotypes (missing ones, 01, read
    as 0), padded rows included."""
    from rs_bann_tpu_torch.io.bed import decode_bed_bytes

    rng = np.random.default_rng(n)
    m, m_pad = 13, 16
    cols = rng.integers(0, 256, size=(m, (n + 3) // 4)).astype(np.uint8)  # every code, 01 too
    raw = np.zeros((m_pad, n), np.float32)
    raw[:m] = decode_bed_bytes(cols, n)
    np.testing.assert_array_equal(TPM.strided_from_bed(cols, n, m_pad), TPM.pack_strided(raw))


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


def _packed(seed, m=M, n=N):
    return JPM.pack_strided(_genotypes(seed, m, n))


def test_packed_matmul_ref_matches_the_jax_kernel():
    rng = np.random.default_rng(5)
    by = _packed(20)
    a = rng.standard_normal((M, K)).astype(np.float32)
    got = TPM.packed_matmul(torch.from_numpy(by), torch.from_numpy(a), N).numpy()
    kern = np.asarray(JPM._pallas_fwd(jnp.asarray(by), jnp.asarray(a), N, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TPM.packed_matmul_ref(torch.from_numpy(by), torch.from_numpy(a),
                                                     N).numpy(), kern, rtol=1e-5, atol=1e-5)


def test_packed_matmul_vjp_ref_matches_the_jax_kernel():
    """K9b's plain version: the cotangent has n rows; JAX's kernel takes it
    zero-padded to the bytes' 4 * B individuals."""
    rng = np.random.default_rng(6)
    by = _packed(21)
    g = (0.1 * rng.standard_normal((N, K))).astype(np.float32)
    g_pad = np.zeros((by.shape[1] * 4, K), np.float32)
    g_pad[:N] = g
    got = TPM.packed_matmul_vjp_ref(torch.from_numpy(by), torch.from_numpy(g), N).numpy()
    kern = np.asarray(JPM._pallas_bwd(jnp.asarray(by), jnp.asarray(g_pad), N, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", JPM.FUSED_ACTIVATIONS)
def test_packed_linear_vjp_ref_matches_the_jax_kernel(act):
    """K3's plain version against _pallas_bwd_fused, n = 700 (not a multiple
    of 512); the saved output has exact zeros, where h' is 0 for relu and
    leaky_relu."""
    rng = np.random.default_rng(7)
    by = _packed(22)
    g = (0.1 * rng.standard_normal((N, K))).astype(np.float32)
    out = rng.standard_normal((N, K)).astype(np.float32)
    out[::5] = 0.0
    B4 = by.shape[1] * 4
    g_pad, out_pad = np.zeros((B4, K), np.float32), np.zeros((B4, K), np.float32)
    g_pad[:N], out_pad[:N] = g, out
    da, d_off = TPM.packed_linear_vjp(torch.from_numpy(by), torch.from_numpy(g),
                                      torch.from_numpy(out), N, act)
    j_da, j_doff = JPM._pallas_bwd_fused(jnp.asarray(by), jnp.asarray(g_pad), jnp.asarray(out_pad),
                                        N, act, interpret=True)
    np.testing.assert_allclose(da.numpy(), np.asarray(j_da), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_off.numpy(), np.asarray(j_doff)[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m_pad", [24, 136])  # 136: wider than one JAX marker tile
@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu", "tanh", "silu"])
def test_autograd_through_the_packed_layer0_matches_jax_vjp(act, m_pad):
    """The port's D.forward on a PackedX (w_scale / shift folding, K2 + K3,
    or K9a + K9b under silu) differentiated by autograd against jax.vjp of
    JAX's D.forward, for a depth-1 branch and a cotangent on its output."""
    rng = np.random.default_rng(8)
    by = _packed(23, m=m_pad)
    scale = rng.uniform(0.5, 2.0, m_pad).astype(np.float32)
    shift = rng.uniform(0.0, 2.0, m_pad).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in ((m_pad, K), (K, 8), (8, 1))]
    bs = [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in (K, 8)]
    ct = (0.1 * rng.standard_normal((N, 1))).astype(np.float32)

    jx = JD.PackedX(jnp.asarray(by), jnp.asarray(scale), jnp.asarray(shift), N)
    out, vjp = jax.vjp(lambda w, b: JD.forward(act, w, b, jx)[1][-1],
                       tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    jgw, jgb = vjp(jnp.asarray(ct))

    tx = TD.PackedX(torch.from_numpy(by), torch.from_numpy(scale), torch.from_numpy(shift), N)
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    tb = [torch.from_numpy(b).requires_grad_() for b in bs]
    t_out = TD.forward(act, tw, tb, tx)[1][-1]
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(t_out, tw + tb, torch.from_numpy(ct))
    for t, j in zip(grads, tuple(jgw) + tuple(jgb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_cpu_vjp_paths_launch_no_kernel():
    by = torch.from_numpy(_packed(24))
    a = torch.ones(M, K, requires_grad=True)
    before = (TPM.packed_matmul.launches, TPM.packed_matmul_vjp.launches,
              TPM.packed_linear_vjp.launches)
    TPM.packed_matmul(by, a, N).sum().backward()
    TPM.packed_linear(by, a, torch.zeros(K), N, "tanh").sum().backward()
    assert (TPM.packed_matmul.launches, TPM.packed_matmul_vjp.launches,
            TPM.packed_linear_vjp.launches) == before
