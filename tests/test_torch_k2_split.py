"""The arithmetic of K2 and K9a (rs_bann_tpu_torch/csrc/packed_linear.cu) on
the CPU: the kernel runs only on the card, so these tests hold an emulation
of what it computes, written here and not in the package, to the port's
plain version and to the JAX package's ``_packed_matmul_ref``.

1. The exact split: every finite f32 ``a`` over a wide exponent range is
   hi + mid + lo of three bf16 parts, bit for bit, so the three bf16
   products of a genotype (0, 1 or 2, exact in bf16) are exact in f32.
2. The decode: the prmt selectors and lookup words give the bf16 bits of
   every genotype code of every byte pair, for each part q.
3. The kernel's data layout and sums: an emulation of one launch with the
   kernel's fragment layouts (the m16n8k16 A, B and D layouts of PTX), its
   permutations of the 16 markers of a chunk and of the 16 byte columns of a
   warp, the weight planes, three MMAs per fragment into f32 accumulators,
   and its epilogue, against the plain version and JAX within REL_TOL of the
   largest entry (f32 sums in another order).
4. The epilogue's copy to global memory visits each element once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_bann_tpu.ops.packed_matmul import _packed_matmul_ref as jax_packed_matmul_ref
from rs_bann_tpu_torch.ops import packed_matmul as PM
from rs_bann_tpu_torch.ops.activations import apply as act_apply

REL_TOL = 1e-4  # as chip_smoke.py: f32 sums over <= 300 markers in another order

LUT_HI, LUT_LO = 0x003F0040, 0x00800000  # as packed_linear.cu


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even bf16 bits of f32 values, as __float2bfloat16_rn."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)


def bf16_value(bits) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def split3(a: np.ndarray):
    """hi, mid, lo as the kernel computes them, as f32 values."""
    hi = bf16_value(bf16_bits(a))
    r1 = (a - hi).astype(np.float32)
    mid = bf16_value(bf16_bits(r1))
    lo = bf16_value(bf16_bits((r1 - mid).astype(np.float32)))
    return hi, mid, lo


# ------------------------------------------------------------ 1. the split


@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, 100), (-58, 58), (-20, 10)])
def test_three_bf16_parts_sum_to_a_exactly(lo_exp, hi_exp):
    rng = np.random.default_rng(lo_exp + 1000)
    n = 200_000
    a = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(lo_exp, hi_exp + 1, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    a[:4] = [0.0, 1.0, -3.0, np.float32(1 + 2 ** -23)]
    hi, mid, lo = split3(a)
    # the last part needs no rounding, and the parts add up to a bit for bit
    r2 = ((a - hi).astype(np.float32) - mid).astype(np.float32)
    np.testing.assert_array_equal(lo.view(np.uint32), r2.view(np.uint32))
    total = ((hi + mid).astype(np.float32) + lo).astype(np.float32)
    np.testing.assert_array_equal(total.view(np.uint32), a.view(np.uint32))
    # each product with a genotype is exact in f32
    for x in (1.0, 2.0):
        for part in (hi, mid, lo):
            np.testing.assert_array_equal((np.float64(x) * part).astype(np.float32),
                                          np.float64(x) * part)


# ----------------------------------------------------------- 2. the decode


def prmt(a, b, sel):
    """PTX prmt.b32 (default mode, selector nibbles 0-7), elementwise."""
    a, b, sel = (np.asarray(v, np.uint64) for v in (a, b, sel))
    src = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b, sel).shape, np.uint64)
    for j in range(4):
        idx = (sel >> np.uint64(4 * j)) & np.uint64(7)
        out |= ((src >> (idx * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * j)
    return out.astype(np.uint32)


def selectors(pair, q):
    pair = np.asarray(pair, np.uint64)
    return ((((pair >> np.uint64(2 * q)) & np.uint64(0x03030303)) * np.uint64(0x11)
             + np.uint64(0x04040404)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def genotype(byte, q):
    code = (np.asarray(byte, np.int64) >> (2 * q)) & 3
    return (18 >> (2 * code)) & 3


def test_prmt_decode_gives_the_bf16_bits_of_every_genotype():
    words = np.arange(2 ** 16, dtype=np.uint32)
    words = words | (words[::-1] << 16)  # every byte pair, in both halves
    for q in range(4):
        s = selectors(words, q)
        for half, sel in ((0, s), (1, s >> 16)):
            got = prmt(LUT_HI, LUT_LO, sel)
            b0 = (words >> (16 * half)) & 0xFF
            b1 = (words >> (16 * half + 8)) & 0xFF
            want = (bf16_bits(genotype(b0, q).astype(np.float32)).astype(np.uint32)
                    | (bf16_bits(genotype(b1, q).astype(np.float32)).astype(np.uint32) << 16))
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------- 3. the kernel's layout and sums


def pick_nt(k):
    return 1 if k <= 8 else 2 if k <= 16 else 4 if k <= 32 else 5 if k <= 40 else 8


def k_position(u):
    return 4 * (u & 3) + (u >> 2)


def emulate(bytes_g, a, off, n, act):
    """One launch of packed_linear.cu (``act`` None: K9a) on one slab, with
    the kernel's fragments and index maps; f32 accumulators, each MMA's
    16-term sum of exact products rounded to f32 once."""
    G, m, B = bytes_g.shape
    k = a.shape[-1]
    NT = pick_nt(k)
    CT = 8 * NT
    npass = -(-k // CT)
    ms = -(-m // 16) * 16
    T = B // 64
    lane = np.arange(32)
    r, tig = lane >> 2, lane & 3
    out = np.full((G, n, k), np.nan, np.float32)
    for g in range(G):
        tiles = np.zeros((T, ms, 64), np.uint8)  # [tile, marker row, byte column]
        tiles[:, :m] = bytes_g[g].reshape(m, T, 64).transpose(1, 0, 2)
        for p in range(npass):
            # weight planes [part, column, position], as stage_weights
            wa = np.zeros((ms, CT), np.float32)
            cols = min(CT, k - p * CT)
            wa[:m, :cols] = a[g, :, p * CT:p * CT + cols]
            planes = np.zeros((3, CT, ms), np.float32)
            pos = (np.arange(ms) & ~15) + k_position(np.arange(ms) & 15)
            for part, v in enumerate(split3(wa)):
                planes[part][:, pos] = v.T
            acc = np.zeros((T, 4, 4, 16, CT), np.float32)  # tile, warp, q, row, column
            for c in range(ms // 16):
                # the bytes of every (tile, warp, lane): markers tig + 4i of
                # the chunk, byte columns 2r (low byte) and 2r + 1 of the warp's 16
                cols16 = np.arange(4)[:, None] * 16 + 2 * r[None, :]  # [warp, lane]
                u = []
                for i in range(4):
                    rows_i = (c * 16 + tig + 4 * i)[None, :]
                    u.append(tiles[:, rows_i, cols16].astype(np.uint32)
                             | (tiles[:, rows_i, cols16 + 1].astype(np.uint32) << 8))
                p01, p23 = prmt(u[0], u[1], 0x5140), prmt(u[2], u[3], 0x5140)
                A = np.zeros((T, 4, 4, 16, 16), np.float64)
                for q in range(4):
                    s01, s23 = selectors(p01, q), selectors(p23, q)
                    regs = [prmt(LUT_HI, LUT_LO, s) for s in (s01, s01 >> 16, s23, s23 >> 16)]
                    for reg, (row_off, col_off) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                        for h in range(2):
                            val = bf16_value((regs[reg] >> (16 * h)) & 0xFFFF)
                            A[:, :, q, r + row_off, 2 * tig + col_off + h] = val
                for nt in range(NT):
                    for part in range(3):
                        Bm = np.zeros((16, 8), np.float64)
                        base = c * 16 + 4 * tig
                        col = nt * 8 + r
                        for h in range(2):
                            Bm[2 * tig + h, r] = planes[part, col, base + h]
                            Bm[2 * tig + 8 + h, r] = planes[part, col, base + 2 + h]
                        d = (A @ Bm).astype(np.float32)  # [T, warp, q, 16, 8]
                        acc[..., nt * 8:(nt + 1) * 8] = (acc[..., nt * 8:(nt + 1) * 8] + d) \
                            .astype(np.float32)
            # epilogue: logical row rho is byte column 2 rho (rho < 8) or 2 (rho - 8) + 1
            phys = np.where(np.arange(16) < 8, 2 * np.arange(16), 2 * (np.arange(16) - 8) + 1)
            for t in range(T):
                grp, half = t >> 1, t & 1
                for w in range(4):
                    for q in range(4):
                        rows = grp * 512 + q * 128 + half * 64 + w * 16 + phys
                        keep = rows < n
                        v = acc[t, w, q, :, :cols]
                        if act is not None:
                            v = act_apply(act, torch.from_numpy(
                                (v + off[g, p * CT:p * CT + cols]).astype(np.float32))).numpy()
                        out[g, rows[keep], p * CT:p * CT + cols] = v[keep]
    return out


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("k", [16, 64])
def test_kernel_emulation_matches_plain_and_jax(k, wide):
    rng = np.random.default_rng(k + wide)
    G, m, n = 2, 40, 1100
    vals = rng.integers(0, 3, (G, m, n)).astype(np.float32)
    by = np.stack([PM.pack_strided(v) for v in vals])
    if wide:  # magnitudes 1e-6 to 1e3: the lo part of the split matters
        a = 10.0 ** rng.uniform(-6, 3, (G, m, k)) * rng.choice([-1.0, 1.0], (G, m, k))
    else:
        a = 0.2 * rng.standard_normal((G, m, k))
    a = a.astype(np.float32)
    off = rng.standard_normal((G, k)).astype(np.float32)

    z = emulate(by, a, off, n, None)
    ref = PM.packed_matmul_ref(torch.from_numpy(by), torch.from_numpy(a), n).numpy()
    jref = np.stack([np.asarray(jax_packed_matmul_ref(jnp.asarray(by[g]), jnp.asarray(a[g]), n))
                     for g in range(G)])
    for want in (ref, jref):
        assert np.abs(z - want).max() <= REL_TOL * max(1.0, np.abs(want).max())
    # the exact products: against the sums in f64, every row within f32 rounding
    exact = np.einsum("gmn,gmk->gnk", vals.astype(np.float64), a.astype(np.float64))
    assert np.abs(z - exact).max() <= 1e-6 * max(1.0, np.abs(exact).max())

    # K2's epilogue: tanh is 1-Lipschitz, so its outputs are held within
    # REL_TOL of the largest pre-activation (the sums' rounding scale)
    out = emulate(by, a, off, n, "tanh")
    lin = PM.packed_linear_ref(torch.from_numpy(by), torch.from_numpy(a), torch.from_numpy(off), n,
                               "tanh").numpy()
    assert np.abs(out - lin).max() <= REL_TOL * max(1.0, np.abs(ref + off[:, None]).max())


# ------------------------------------------------------- 4. the copy out


def copy_walk(rows, U):
    """The (row, unit) pairs lane by lane, as copy_out walks them."""
    seen = []
    for lane in range(32):
        row, col = lane // U, lane - (lane // U) * U
        drow, dcol = 32 // U, 32 - (32 // U) * U
        for _ in range(lane, rows * U, 32):
            seen.append((row, col))
            col, row = col + dcol, row + drow
            if col >= U:
                col, row = col - U, row + 1
    return seen


@pytest.mark.parametrize("rows", [1, 7, 16])
def test_copy_out_visits_each_element_once(rows):
    for U in list(range(1, 40)) + [64, 100]:
        seen = copy_walk(rows, U)
        assert sorted(seen) == [(r, c) for r in range(rows) for c in range(U)], U
