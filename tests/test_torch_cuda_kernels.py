"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; marked ``cuda`` and skipped elsewhere. The
repository's conftest imports jax, which the GPU machine need not have, so
run these with ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.

Shapes are small but cover what the full-shape checks in chip_smoke.py do
not: every activation, depth 0 and 1, a ragged n, a batched G, and the
wrappers' refusals. Tolerances: K2 atol 1e-4 (f32 sums over <= 104 markers
in another order); K4 y_pred atol 1e-4 and gradients rtol 1e-4 against the
largest entry (sums over n in another order).
"""

import numpy as np
import pytest
import torch

from rs_bann_tpu_torch.models.density import PackedX
from rs_bann_tpu_torch.ops import branch_mlp as BM
from rs_bann_tpu_torch.ops import packed_matmul as PM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(rng, G, m, n, dev):
    vals = rng.integers(0, 3, size=(G, m, n)).astype(np.float32)
    return torch.from_numpy(np.stack([PM.pack_strided(v) for v in vals])).to(dev)


@pytest.mark.parametrize("act", PM.FUSED_ACTIVATIONS)
@pytest.mark.parametrize("k", [8, 16, 40])
def test_packed_linear_kernel_matches_plain(dev, act, k):
    rng = np.random.default_rng(0)
    G, m, n = 3, 104, 1300
    by = _bytes(rng, G, m, n, dev)
    a = torch.from_numpy(rng.standard_normal((G, m, k)).astype(np.float32)).to(dev) * 0.2
    off = torch.from_numpy(rng.standard_normal((G, k)).astype(np.float32)).to(dev)
    before = PM.packed_linear.launches
    out = PM.packed_linear(by, a, off, n, act)
    assert PM.packed_linear.launches == before + 1
    ref = PM.packed_linear_ref(by, a, off, n, act)
    torch.cuda.synchronize()
    assert out.shape == (G, n, k)
    assert (out - ref).abs().max().item() <= 1e-4
    single = PM.packed_linear(by[1], a[1], off[1], n, act)
    assert torch.equal(single, out[1])


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("act", BM.SUPPORTED_ACTIVATIONS)
def test_data_vg_packed_kernel_matches_plain(dev, depth, act):
    rng = np.random.default_rng(1)
    m, n = 104, 1300
    by = _bytes(rng, 1, m, n, dev)[0]
    widths = [m] + ([16] if depth else []) + [16, 1]
    ws = tuple(torch.from_numpy((rng.standard_normal((widths[i], widths[i + 1])) * 0.2)
                                .astype(np.float32)).to(dev) for i in range(len(widths) - 1))
    bs = tuple(torch.from_numpy((rng.standard_normal(widths[i + 1]) * 0.1).astype(np.float32)).to(dev)
               for i in range(len(widths) - 2))
    x = PackedX(by, torch.rand(m, device=dev) + 0.5, torch.rand(m, device=dev) * 2, n)
    target = torch.randn(n, device=dev)
    before = BM.data_vg_packed.launches
    y, rss, dws, dbs = BM.data_vg_packed(act, x, ws, bs, target)
    assert BM.data_vg_packed.launches == before + 1
    s = x.w_scale
    wf = (s[:, None] * ws[0],) + ws[1:]
    bf = (bs[0] - x.shift @ wf[0],) + bs[1:]
    y_ref, dws_ref, dbs_ref = BM.data_vg_packed_ref(act, by, target, wf, bf, n)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= 1e-4
    dws_ref = (s[:, None] * dws_ref[0] - (x.shift * s)[:, None] * dbs_ref[0],) + dws_ref[1:]
    for got, ref in zip(dws + dbs, dws_ref + dbs_ref):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)
    # the same inputs give the same bits: no float atomics
    y2, _, dws2, _ = BM.data_vg_packed(act, x, ws, bs, target)
    assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(2)
    m, n = 104, 700
    by = _bytes(rng, 1, m, n, dev)[0]
    with pytest.raises(TypeError):
        PM.packed_linear(by, torch.zeros(m, 8, device=dev, dtype=torch.float64),
                         torch.zeros(8, device=dev, dtype=torch.float64), n, "identity")
    x = PackedX(by, torch.ones(m, device=dev), torch.zeros(m, device=dev), n)
    deep = (torch.zeros(m, 8, device=dev), torch.zeros(8, 8, device=dev),
            torch.zeros(8, 8, device=dev), torch.zeros(8, 1, device=dev))
    with pytest.raises(NotImplementedError):  # depth 2
        BM.data_vg_packed("tanh", x, deep, tuple(torch.zeros(8, device=dev) for _ in range(3)),
                          torch.zeros(n, device=dev))
    wide = (torch.zeros(m, 64, device=dev), torch.zeros(64, 1, device=dev))
    with pytest.raises(NotImplementedError):  # width above 32
        BM.data_vg_packed("tanh", x, wide, (torch.zeros(64, device=dev),), torch.zeros(n, device=dev))
