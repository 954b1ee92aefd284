"""Fused value-and-gradient of the branch MLP's data term: packed, one
branch (K4); dense feature-major, C chains folded (K7); dense
feature-major, one instance per X read (K8a, K8b).

Counterpart of rs_bann_tpu/ops/branch_mlp.py ``data_vg_packed``,
``data_vg_chains`` and ``data_vg``. For one branch network f(x; W, b) on
2-bit packed genotypes ``data_vg_packed`` returns

    y_pred[i]      = f(x_i)                      (i < n)
    rss            = sum_i (y_pred[i] - target[i])^2
    dW_l, db_l     = d(rss / 2) / d(W_l, b_l)    for every layer

Standardization is folded into layer 0 before the pass
(W0' = w_scale * W0, off = b0 - shift @ W0') and unfolded after:

    dW0 = w_scale * dW0' - (shift * w_scale) * d_off,    db0 = d_off

On a CUDA tensor the pass is the hand-written kernel in
csrc/branch_vg_packed.cu (every activation, any depth, padded widths up to
64): at depth 0 and widths up to 32 its depth-0 tensor-core kernel, at
every other shape the design K5 shares (csrc/packed_deep.cuh). The fold,
rss and unfold run inside its two launches (the pass and its fixed-order
reduce), so a call issues no other device op but, past depth 0 or width
32, the one concatenation of the weights into their flat layout; the
kernel sums off = b0 - shift @ W0' in f64 and rounds it once, where the
plain version's f32 fold here rounds each step. On a CPU tensor the pass is
``data_vg_packed_ref``: decode with ``unpack_strided``, dense forward,
autograd for the gradients.

``data_vg_chains`` computes the same for every (branch g, chain c) of
feature-major X xT [G, m_pad, n] (models/density.py ``FeatX``; f32, or
bf16 under ``--x-bf16``), weights[l]
[G, C, in, out], biases[l] [G, C, out] and targets [G, C, n]: one X read
serves all C chains. On a CUDA tensor it is K7, csrc/branch_vg_chains.cu
(every activation; at depth 0 and 1 and widths up to 32 CTAs of CC chains
on each staged X tile, tf32 tensor cores in 3xTF32 on
csrc/dense_vg_mma.cuh, the weights and targets read where they lie; at any
other depth and at padded widths up to 64 the deep design,
csrc/dense_deep.cuh, on the weights concatenated into their flat layout;
rss and the fixed-order sum of the partial rows inside its two launches);
``forward_chains`` is its
forward-only instantiation (y_pred alone, one launch), which the folded
transition's value passes use. On a CPU tensor both run their plain
versions (``data_vg_chains_ref``, ``forward_chains_ref``). Both count their
launches in ``data_vg_chains.launches``.

``data_vg`` is the same for one branch and one chain (xT [m_pad, n]: the
sequential schedule's leapfrog step, K8a), ``data_vg_blocked`` for NB
independent instances, instance i on X[ix[i]] of X [G, m_pad, n] read in
place (every (chain, branch) of an unfolded hybrid block, K8b), and
``forward_blocked`` its y_pred alone. On a CUDA tensor all three are
csrc/branch_vg_dense.cu (tf32 tensor cores in 3xTF32, csrc/dense_vg_mma.cuh,
as K6 and K7): the weights read through their own pointers, rss
and the fixed-order sum of the CTAs' partial rows inside its launches, so a
call issues one pass and its reduce and no other device op; past depth 1
or width 32 (up to 64) the deep design (csrc/dense_deep.cuh), after the one
concatenation of the weights into their flat layout.
Each counts its own launches; on a CPU tensor they run their plain versions
(``data_vg_ref``: autograd of the feature-major forward).

K6, K7 and K8 read feature-major X stored in f32 or in bf16 (``--x-bf16``):
on bf16 X each passes its entry ``x_bf16`` = 1, whose X tile is staged in
bf16 (half the bytes) and whose products take X's exact value against the
f32 weights, unrounded, in f32 (the JAX package's kernels in interpret
mode, ``in_dtype=None``); the plain versions upcast bf16 X exactly and
change nothing else. Any other X dtype raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply
from .packed_matmul import GBYTES, _check, _check_aligned, _check_packed, unpack_strided

SUPPORTED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh", "silu")


def _check_act(act_name):
    if act_name not in SUPPORTED_ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act_name}")


def data_vg_packed_ref(act, bytes_mb, target, weights, biases, n: int):
    """Plain PyTorch version of K4 on pre-folded weights, one branch.

    bytes [m, B] u8; target [n]; weights (W0' [m, k0], ..., w_out [s, 1]);
    biases (off [k0], ...), all f32, or all f64 for a reference in f64 (the
    genotypes are decoded to the weights' dtype). Returns (y_pred [n], dws,
    dbs) with the gradients of rss / 2 in the folded coordinates.
    """
    ws = [w.detach().requires_grad_(True) for w in weights]
    bs = [b.detach().requires_grad_(True) for b in biases]
    with torch.enable_grad():
        a = unpack_strided(bytes_mb, n).to(ws[0].dtype).transpose(0, 1)  # [n, m]
        for l in range(len(ws) - 1):
            a = _act_apply(act, a @ ws[l] + bs[l][None, :])
        pred = (a @ ws[-1])[:, 0]
        half_rss = 0.5 * torch.sum((pred - target) ** 2)
        grads = torch.autograd.grad(half_rss, ws + bs)
    return pred.detach(), tuple(grads[: len(ws)]), tuple(grads[len(ws):])


def _check_packed_widths(m: int, k0: int, s: int, depth: int) -> None:
    if branch_vg_packed_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K4 CUDA kernel takes padded layer widths up to 64 within 227 KB of shared "
            f"memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )


DEEP_PLAN_FIELDS = ("ctas", "row", "km", "ctas_per_sm", "tiles", "smem")


@functools.lru_cache(maxsize=None)
def _deep_plan(device_index: int, m: int, B: int, n: int, k0: int, s: int, depth: int) -> tuple:
    out = (ctypes.c_longlong * len(DEEP_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().branch_vg_packed_deep_plan(m, B, n, k0, s, depth, out),
                     "branch_vg_packed_deep_plan")
    return tuple(out)


def branch_vg_packed_deep_plan(m: int, B: int, n: int, k0: int, s: int, depth: int,
                               device=None) -> dict:
    """What a launch of K4's deep kernel (any depth, or depth 0 at padded
    widths 33-64; csrc/packed_deep.cuh) on one branch of bytes [m, B] with
    n individuals uses on a CUDA device (the current one by default): CTAs
    in the grid (one partial row each), floats per partial row, the width
    class KM, resident CTAs per SM, tiles of 16 byte columns, shared bytes
    per CTA."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(DEEP_PLAN_FIELDS, _deep_plan(index, m, B, n, k0, s, depth)))


def _data_vg_packed_deep_cuda(act, x, weights, biases, target):
    """Launch K4's deep kernel and its reduce for one branch: the fold, rss
    and unfold inside the two launches. Returns (y_pred, rss, dws, dbs)."""
    bytes_mb, n = x.bytes, x.n
    m, B = bytes_mb.shape
    depth = len(weights) - 2
    k0, s = weights[0].shape[1], weights[-1].shape[0]
    dev = bytes_mb.device
    _check_packed(B, n)
    _check_packed_widths(m, k0, s, depth)
    _check(bytes_mb, "bytes", torch.uint8, (m, B), dev)
    _check_aligned(bytes_mb, "bytes")
    _check(target, "target", torch.float32, (n,), dev)
    _check(x.w_scale, "w_scale", torch.float32, (m,), dev)
    _check(x.shift, "shift", torch.float32, (m,), dev)
    P = _flat_size(m, k0, s, depth)
    q = flat_params(weights, biases)
    _check(q, "weights", torch.float32, (P,), dev)
    ctas, row = _deep_plan(dev.index, m, B, n, k0, s, depth)[:2]
    partial = torch.empty(ctas * row, dtype=torch.float32, device=dev)  # the entry checks the size
    out = torch.empty(n + P + 1, dtype=torch.float32, device=dev)
    status = _build.lib().branch_vg_packed_deep_f32(
        bytes_mb.data_ptr(), target.data_ptr(), q.data_ptr(), x.w_scale.data_ptr(),
        x.shift.data_ptr(), out.data_ptr(), partial.data_ptr(), partial.numel(),
        out.data_ptr() + 4 * n, m, B, n, k0, s, depth, ACT_CODES[act], _build.stream_ptr(bytes_mb))
    _build.check(status, "branch_vg_packed_deep_f32")
    data_vg_packed.launches += 1
    dws, dbs = _grad_views(out[n : n + P], (), m, k0, s, depth)
    return out[:n], out[n + P].view(()), dws, dbs


PLAN0_FIELDS = ("ctas", "row", "nt", "buffers", "ctas_per_sm", "tiles", "smem", "weight_row")


@functools.lru_cache(maxsize=None)
def _plan0(device_index: int, m: int, B: int, n: int, k0: int) -> tuple:
    out = (ctypes.c_longlong * len(PLAN0_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().branch_vg_packed0_plan(m, B, n, k0, out),
                     "branch_vg_packed0_plan")
    return tuple(out)


def branch_vg_packed0_plan(m: int, B: int, n: int, k0: int, device=None) -> dict:
    """What a launch of K4's depth-0 kernel on one branch of bytes [m, B]
    with n individuals and width k0 uses on a CUDA device (the current one
    by default), as the kernel picks it from the shape: CTAs in the grid
    (one partial row each) and floats per partial row, column tiles of 8
    (nt), byte tile buffers, resident CTAs per SM, tiles of 64 byte
    columns, shared bytes per CTA and bf16 per weight plane row."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(PLAN0_FIELDS, _plan0(index, m, B, n, k0)))


def _data_vg_packed0_cuda(act, x, weights, biases, target):
    """Launch K4's depth-0 kernel and its reduce for one branch: the fold,
    rss and unfold inside the two launches. Returns (y_pred, rss, dws, dbs)."""
    bytes_mb, n = x.bytes, x.n
    m, B = bytes_mb.shape
    k0 = weights[0].shape[1]
    dev = bytes_mb.device
    _check_packed(B, n)
    _check_packed_widths(m, k0, weights[1].shape[0], 0)
    w0, wout, b0 = weights[0].contiguous(), weights[1].contiguous(), biases[0].contiguous()
    _check(bytes_mb, "bytes", torch.uint8, (m, B), dev)
    _check_aligned(bytes_mb, "bytes")
    _check(target, "target", torch.float32, (n,), dev)
    _check(w0, "w0", torch.float32, (m, k0), dev)
    _check(b0, "b0", torch.float32, (k0,), dev)
    _check(wout, "w_out", torch.float32, (k0, 1), dev)
    _check(x.w_scale, "w_scale", torch.float32, (m,), dev)
    _check(x.shift, "shift", torch.float32, (m,), dev)
    ctas, row = _plan0(dev.index, m, B, n, k0)[:2]
    partial = torch.empty(ctas * row, dtype=torch.float32, device=dev)  # the entry checks the size
    mk = m * k0
    out = torch.empty(n + mk + 2 * k0 + 1, dtype=torch.float32, device=dev)
    status = _build.lib().branch_vg_packed0_f32(
        bytes_mb.data_ptr(), target.data_ptr(), w0.data_ptr(), b0.data_ptr(), wout.data_ptr(),
        x.w_scale.data_ptr(), x.shift.data_ptr(), out.data_ptr(), partial.data_ptr(),
        partial.numel(), out.data_ptr() + 4 * n, m, B, n, k0, ACT_CODES[act],
        _build.stream_ptr(bytes_mb))
    _build.check(status, "branch_vg_packed0_f32")
    data_vg_packed.launches += 1
    y_pred, dW0, db0, dWout, rss = out.split_with_sizes((n, mk, k0, k0, 1))
    return y_pred, rss.view(()), (dW0.view(m, k0), dWout.view(k0, 1)), (db0,)


def data_vg_packed(act_name, x, weights, biases, target):
    """Fused packed value-and-gradient for one branch, same contract as the
    JAX package's: ``x`` is a single-branch PackedX (models/density.py),
    ``weights``/``biases`` the branch's layers in the stacked layout.

    Returns (y_pred [n], rss, dws, dbs): the data term's prediction, rss and
    the gradients of rss / 2.
    """
    _check_act(act_name)
    if x.bytes.device.type != "cpu":
        if len(weights) == 2 and _pick_km(weights[0].shape[1], weights[1].shape[0]) > 0:
            return _data_vg_packed0_cuda(act_name, x, weights, biases, target)
        return _data_vg_packed_deep_cuda(act_name, x, weights, biases, target)
    s = x.w_scale
    w0p = s[:, None] * weights[0]
    off = biases[0] - x.shift @ w0p
    wf = (w0p,) + tuple(weights[1:])
    bf = (off,) + tuple(biases[1:])
    y_pred, dws, dbs = data_vg_packed_ref(act_name, x.bytes, target, wf, bf, x.n)
    rss = torch.sum((y_pred - target) ** 2)
    dW0 = s[:, None] * dws[0] - (x.shift * s)[:, None] * dbs[0]
    return y_pred, rss, (dW0,) + tuple(dws[1:]), dbs


data_vg_packed.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------ dense chains (K7)

_MAX_SMEM = 232448  # dynamic shared memory a block may use
_KS, _WARPS = 40, 4  # csrc/dense_vg_mma.cuh: row stride of [rows][32] buffers, warps per group
X_DTYPES = (torch.float32, torch.bfloat16)  # feature-major X as K6, K7 and K8 take it


def _x_bytes(x_dtype) -> int:
    """Bytes of one X element in a dense kernel's staged tile."""
    if x_dtype not in X_DTYPES:
        raise TypeError(f"feature-major X must be float32 or bfloat16, not {x_dtype}")
    return 2 if x_dtype == torch.bfloat16 else 4


def x_bf16(x_dtype) -> int:
    """The dense entries' (and their plans' and rules') ``x_bf16`` argument
    for X of this dtype: 1 on bf16, 0 on f32."""
    return int(_x_bytes(x_dtype) == 2)


def _check_x(X, shape, dev) -> int:
    """Check feature-major X for K6, K7 or K8 (contiguous, on ``dev``, f32 or
    bf16); returns the entries' ``x_bf16`` argument for its dtype."""
    _check(X, "X", X.dtype if X.dtype in X_DTYPES else torch.float32, shape, dev)
    return x_bf16(X.dtype)


def _pick_km(k0: int, s: int) -> int:
    """Padded register width of layers of widths k0 and s, or -1 above 32
    (csrc/packed_decode.cuh pick_km)."""
    return next((k for k in (8, 16, 32) if max(k0, s) <= k), -1)


def _dense_smem(m: int, k0: int, s: int, depth: int, rss: bool, x_dtype=torch.float32) -> int:
    """csrc/dense_vg_mma.cuh ``cta_smem`` of the value-and-gradient pass at
    one chain per CTA and one X buffer: the X tile ([m16][40] in X's dtype)
    and one group's weight fragments, planes, accumulators, vectors and
    small sums (with ``rss`` its err^2 too, ``group_floats``), within 227
    KB; -1 past depth 1 or a width above 32."""
    km = _pick_km(k0, s)
    if km < 0 or depth not in (0, 1) or m <= 0:
        return -1
    deep, k16 = depth == 1, max(km, 16)
    m16, m8, mt, plane = -(-m // 16) * 16, -(-m // 8) * 8, k16 // 16, k16 * _KS
    floats = (m8 // 8) * mt * 256 + (2 * (km // 8) * mt * 256 + plane if deep else 0)
    floats += plane * (2 if deep else 1) + (m16 + (k16 if deep else 0)) * (40 if km == 32 else 24)
    floats += 3 * k16 + _WARPS * 3 * k16 + (2 * _WARPS if rss else 0)
    smem = _x_bytes(x_dtype) * m16 * _KS + 4 * floats
    return smem if smem <= _MAX_SMEM else -1


_DEEP_XS = 72  # csrc/dense_deep.cuh: row stride of the X tile (kXS)


def dense_deep(k0: int, s: int, depth: int) -> bool:
    """Whether K6, K7 and K8 run a shape on their deep design
    (csrc/dense_deep.cuh ``takes``): depth 2 or more, or a padded width
    above 32."""
    return depth >= 2 or _pick_km(k0, s) < 0


def dense_deep_smem(m: int, k0: int, s: int, depth: int, x_dtype=torch.float32) -> int:
    """Shared memory of one CTA of the dense deep design (csrc/dense_deep.cuh
    ``layout``) with one X tile buffer (the kernels take a second where it
    fits), or -1 above width 64 or past 227 KB: the X tile [m16][72] in X's
    dtype, W0 [m16][ws] in f32 (ws = KM + 16 at KM = 8, else KM + 8), b0,
    w_out and each hidden layer's W_l^T and b_l, the tile's depth + 2 rows
    of activations [64][KM + 4] and a few sums."""
    km = _packed_km(k0, s)
    if km < 0 or m <= 0 or depth < 0:
        return -1
    m16 = -(-m // 16) * 16
    ws = km + 16 if km % 32 == 8 else km + 8
    floats = (m16 * ws + 2 * km + depth * (km * km + km)
              + (depth + 2) * _DEEP_TILE * (km + 4) + 5 * _DEEP_TILE + _DEEP_THREADS // 32)
    smem = _x_bytes(x_dtype) * m16 * _DEEP_XS + 4 * floats
    return smem if smem <= _MAX_SMEM else -1


def _dense_rule(m: int, k0: int, s: int, depth: int, rss: bool, x_dtype) -> int:
    """The rule K6, K7 and K8 share: at depth 0 and 1 and padded widths up
    to 32 their first design's (``_dense_smem``), at every other shape the
    deep design's with one X buffer; the X tile in X's dtype."""
    if dense_deep(k0, s, depth):
        return dense_deep_smem(m, k0, s, depth, x_dtype)
    return _dense_smem(m, k0, s, depth, rss, x_dtype)


def traj_dense_smem(m: int, k0: int, s: int, depth: int, x_dtype=torch.float32) -> int:
    """Shared memory (bytes) K6 needs for one branch of m_pad markers and
    layer widths k0, s at one chain per CTA on X of ``x_dtype`` (f32, or
    bf16: a tile of half the bytes), or -1 if it cannot run it (a padded
    width above 64, or more than 227 KB). The rule of the CUDA entry point
    of the same name (its ``x_bf16`` argument 1 on bf16 X); the CLI asks
    it, with ``vg_chains_smem``, before a folded feature-major run on the
    card."""
    return _dense_rule(m, k0, s, depth, False, x_dtype)


def vg_chains_smem(m: int, k0: int, s: int, depth: int, x_dtype=torch.float32) -> int:
    """K7's rule, as ``traj_dense_smem``: its value-and-gradient pass also
    keeps each warp's err^2 in the first design (the forward-only pass needs
    less)."""
    return _dense_rule(m, k0, s, depth, True, x_dtype)


def vg_dense_smem(m: int, k0: int, s: int, depth: int, x_dtype=torch.float32) -> int:
    """K8's rule, as ``traj_dense_smem`` (its CTA is one chain's group, with
    err^2 as K7's); the CLI asks it before a sequential or unfolded
    feature-major run on the card."""
    return _dense_rule(m, k0, s, depth, True, x_dtype)


_PACKED_ROW = GBYTES + 4  # shared-memory row stride of the depth-0 rule's byte tile (kRow)
# csrc/packed_deep.cuh: threads per CTA, individuals per tile, words per dz0 column
_DEEP_THREADS, _DEEP_TILE, _DEEP_DZS = 256, 64, 34


def _packed_km(k0: int, s: int) -> int:
    """The packed rules' width class of layers of widths k0 and s: 8, 16,
    32 or 64, -1 above 64 (csrc/packed_deep.cuh pick_km64)."""
    return next((k for k in (8, 16, 32, 64) if max(k0, s) <= k), -1)


def _depth0_smem(m: int, k0: int, s: int, extra_floats: int) -> int:
    """The depth-0 rule at padded widths up to 32 that K4 and K5 share
    (the first f32 layout, kept): register width KM from ``pick_km``, the
    weights and one [512, KM + 4] row tile, the byte tile, within 227 KB.
    ``extra_floats`` is what the kernel adds of its own."""
    km = _pick_km(k0, s)
    floats = 4 * GBYTES * (km + 4) + m * km + km + km + 4 * km + extra_floats
    smem = 4 * floats + m * _PACKED_ROW
    return smem if smem <= _MAX_SMEM else -1


def deep_smem(m: int, k0: int, s: int, depth: int, cc: int = 1) -> int:
    """Shared memory of one CTA of the deep design (csrc/packed_deep.cuh
    ``layout``) for chunks of ``cc`` chains, or -1 above width 64 or past
    227 KB: the fold's f64 slices, two byte tiles, per chain W0' in three
    bf16 planes and off, w_out and each hidden layer's W_l^T and b_l in f32,
    the tile's depth + 2 rows of activations, dz0's three bf16 planes and a
    few sums."""
    km = _packed_km(k0, s)
    if km < 0 or m <= 0 or depth < 0:
        return -1
    m16 = -(-m // 16) * 16
    wstride = m16 if (m16 // 16) % 2 else m16 + 16
    smem = (8 * _DEEP_THREADS + 2 * m16 * 16 + 6 * cc * km * wstride
            + 4 * cc * (2 * km + depth * (km * km + km)) + 4 * (depth + 2) * _DEEP_TILE * (km + 4)
            + 12 * km * _DEEP_DZS + 4 * (5 * _DEEP_TILE + _DEEP_THREADS // 32))
    return smem if smem <= _MAX_SMEM else -1


def _packed_smem(m: int, k0: int, s: int, depth: int, extra_floats: int) -> int:
    """The rule K4 and K5 share: at depth 0 and padded widths up to 32 the
    depth-0 rule, at every other shape the deep design's at one chain."""
    if depth == 0 and _pick_km(k0, s) > 0:
        return _depth0_smem(m, k0, s, extra_floats)
    return deep_smem(m, k0, s, depth)


@functools.lru_cache(maxsize=None)
def branch_vg_packed_smem(m: int, k0: int, s: int, depth: int) -> int:
    """Shared memory (bytes) K4 needs for one branch of m_pad markers and
    padded widths k0, s at this depth, or -1 if it cannot run it. The rule
    of the CUDA entry point of the same name; the CLI asks it before a
    packed HMC run on the card whose branches step one by one."""
    return _packed_smem(m, k0, s, depth, 0)


def traj_packed_smem(m: int, k0: int, s: int, depth: int) -> int:
    """Shared memory (bytes) K5 needs at the padded widths, or -1 if it
    cannot run them: K4's rule, plus each marker's scale and offset at depth
    0 and widths up to 32. The rule of the CUDA entry point of the same
    name; the CLI asks it before a folded packed HMC run on the card. (At
    depth 0 K5 computes only a block's live columns, which never need
    more; the deep design takes more chains a chunk only where they fit.)"""
    return _packed_smem(m, k0, s, depth, 2 * m)


def flat_params(weights, biases) -> torch.Tensor:
    """Per-layer tensors [*lead, in, out] (biases [*lead, out]) -> [*lead, P]
    in the kernels' layout: W0, b0, (W_l, b_l)..., w_out."""
    lead = weights[-1].shape[:-2]
    parts = []
    for w, b in zip(weights[:-1], biases):
        parts += [w.reshape(lead + (-1,)), b.reshape(lead + (-1,))]
    parts.append(weights[-1].reshape(lead + (-1,)))
    return torch.cat(parts, dim=-1).to(torch.float32).contiguous()


def unflat_params(flat, like_w, like_b):
    """Inverse of ``flat_params``: views of ``flat`` shaped as like_w / like_b."""
    ws, bs, ix = [], [], 0
    for w, b in zip(like_w[:-1], like_b):
        size = w[0, 0].numel()
        ws.append(flat[..., ix : ix + size].reshape(w.shape))
        ix += size
        bs.append(flat[..., ix : ix + b.shape[-1]].reshape(b.shape))
        ix += b.shape[-1]
    ws.append(flat[..., ix:].reshape(like_w[-1].shape))
    return tuple(ws), tuple(bs)


def _forward_fm(act, xT, weights, biases) -> torch.Tensor:
    """Feature-major forward: z [..., out, n] = W^T a + b per layer, then the
    width-1 output as a sum over the summary rows. xT [..., m_pad, n] (bf16
    upcast exactly to the weights' dtype), weights[l] [..., in, out] ->
    y_pred [..., n] (models/density.py ``forward`` on a FeatX, but for its
    bf16 rounding of W0)."""
    a = xT.to(weights[0].dtype) if xT.dtype == torch.bfloat16 else xT
    for l in range(len(weights) - 1):
        a = _act_apply(act, weights[l].transpose(-1, -2) @ a + biases[l][..., None])
    return torch.sum(weights[-1] * a, dim=-2)


def forward_chains_ref(act, xT, weights, biases) -> torch.Tensor:
    """Feature-major forward of C chains: xT [G, m_pad, n], weights[l]
    [G, C, in, out] -> y_pred [G, C, n]."""
    return _forward_fm(act, xT[:, None], weights, biases)


def data_vg_chains_ref(act, xT, weights, biases, target):
    """Plain PyTorch version of K7: the feature-major forward, autograd for
    the gradients of rss / 2. Returns (y_pred [G, C, n], rss [G, C], dws,
    dbs)."""
    ws = [w.detach().requires_grad_(True) for w in weights]
    bs = [b.detach().requires_grad_(True) for b in biases]
    with torch.enable_grad():
        pred = forward_chains_ref(act, xT, ws, bs)
        half_rss = 0.5 * torch.sum((pred - target) ** 2)
        grads = torch.autograd.grad(half_rss, ws + bs)
    pred = pred.detach()
    rss = torch.sum((pred - target) ** 2, dim=-1)
    return pred, rss, tuple(grads[: len(ws)]), tuple(grads[len(ws):])


def _dense_shape(xT, weights, rule, kernel):
    """(G, C, m, n, k0, s, depth) of a chain-folded call; raises
    NotImplementedError where ``kernel``'s shared-memory ``rule`` refuses
    the shape on X's dtype."""
    G, m, n = xT.shape
    depth = len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    if rule(m, k0, s, depth, xT.dtype) < 0:
        raise NotImplementedError(
            f"the {kernel} CUDA kernel takes padded layer widths up to 64 within 227 KB of "
            f"shared memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )
    return G, weights[0].shape[1], m, n, k0, s, depth


def _dims(m: int, k0: int, s: int, depth: int) -> list:
    """[(in, out)] of every layer but the output: W0 [m, k0], then the
    hidden layers W_l [k0, k0] and the last W_D [k0, s]."""
    return [(m, k0)] + [(k0, k0 if l < depth else s) for l in range(1, depth + 1)]


def _flat_size(m: int, k0: int, s: int, depth: int) -> int:
    """Length P of one branch's gradients in the kernels' order W0, b0,
    (W_l, b_l)..., w_out."""
    return sum(i * o + o for i, o in _dims(m, k0, s, depth)) + s


def _grad_views(grads, pre, m, k0, s, depth):
    """Per-layer views (dws, dbs) of gradients ``grads`` [*pre, P] in the
    kernels' order, shaped as the weights [*pre, in, out] and biases
    [*pre, out]."""
    dims = _dims(m, k0, s, depth)
    parts = grads.split([n for i, o in dims for n in (i * o, o)] + [s], dim=-1)
    dws = tuple(parts[2 * l].view(pre + d) for l, d in enumerate(dims)) + (parts[-1].view(pre + (s, 1)),)
    return dws, tuple(parts[2 * l + 1] for l in range(len(dims)))


def layer_slots(ws, bs, depth):
    """Per-layer tensors (or shapes) in the kernels' slots W0, b0, W1, b1,
    w_out (None for W1 and b1 at depth 0)."""
    return [ws[0], bs[0]] + ([ws[1], bs[1]] if depth else [None, None]) + [ws[-1]]


def layer_shapes(G, C, m, k0, s, depth):
    """The [G, C, ...] shapes of the five slots of ``layer_slots``."""
    dims = [(m, k0)] + ([(k0, s)] if depth else []) + [(s, 1)]
    return layer_slots([(G, C) + d for d in dims], [(G, C, d[1]) for d in dims[:-1]], depth)


def _instances(t, name, shape, dev, any_strides=False):
    """A [G, C, ...] f32 tensor as K6 and K7 read it: (the tensor, its
    pointer, its strides over branches, chains, rows and columns; a bias
    [G, C, cols] is one row). With ``any_strides`` (K6's step sizes and
    prior factors) it is read where it lies, broadcast dims included; else
    its trailing dims must be contiguous, and a tensor whose are not is
    copied."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not any_strides and not t[0, 0].is_contiguous():
        t = t.contiguous()
    if t.dim() == 4:
        rows_cols = t.stride()[2:]
    elif t.dim() == 3:
        rows_cols = (0, t.stride(2))
    else:
        rows_cols = (0, 0)
    return t, t.data_ptr(), (t.stride(0), t.stride(1)) + tuple(rows_cols)


def pass_instances(items, dev):
    """What a C entry of K6 or K7 takes for its [G, C, ...] tensors, each
    item (tensor or None, name, shape, any_strides) by ``_instances``:
    (the tensors to keep alive, one pointer each (None: null), four strides
    each)."""
    keep, ptrs, strides = [], [], []
    for t, name, shape, any_strides in items:
        if t is None:
            ptrs.append(None)
            strides.extend((0, 0, 0, 0))
            continue
        t, ptr, st = _instances(t, name, shape, dev, any_strides)
        keep.append(t)
        ptrs.append(ptr)
        strides.extend(st)
    return keep, ptrs, strides


def chain_instances(target, weights, biases, dev):
    """What K7's C entry takes for the targets [G, C, n] (None for the
    forward-only pass) and the per-layer weights [G, C, in, out] and biases
    [G, C, out], each read where it lies (``pass_instances``)."""
    G, C, m, k0 = weights[0].shape
    depth, s = len(weights) - 2, weights[-1].shape[-2]
    n = None if target is None else target.shape[-1]
    layers = zip(layer_slots(weights, biases, depth), layer_shapes(G, C, m, k0, s, depth))
    return pass_instances([(target, "target", (G, C, n), False)]
                          + [(t, f"layer {k}", sh, False) for k, (t, sh) in enumerate(layers)],
                          dev)


_SCRATCH = {}  # (kernel, device index, shape) -> the kernel's scratch, made once


def _scratch(dev, key, nbytes: int) -> torch.Tensor:
    """The scratch (partial rows, err^2) of one kernel and shape: later
    calls allocate nothing."""
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return buf


K7_PLAN_FIELDS = ("ctas", "ctas_per_sm", "cc", "chunks", "tiles", "smem", "buffers", "scratch",
                  "km")


@functools.lru_cache(maxsize=None)
def _k7_plan(device_index: int, G: int, C: int, m: int, n: int, k0: int, s: int, depth: int,
             grad: bool, act: int, xb: int = 0) -> tuple:
    out = (ctypes.c_longlong * len(K7_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().vg_chains_plan(G, C, m, n, k0, s, depth, int(grad), act, xb,
                                                 out), "vg_chains_plan")
    return tuple(out)


def vg_chains_plan(G: int, C: int, m: int, n: int, k0: int, s: int, depth: int,
                   grad: bool = True, act: str = "tanh", device=None,
                   x_dtype=torch.float32) -> dict:
    """What a K7 launch for G branches of m_pad markers, C chains and n
    individuals under ``act`` on X of ``x_dtype`` uses on a CUDA device (the
    current one by default), value and gradient or (``grad`` False) forward
    only: CTAs in the grid, resident CTAs per SM, chains per CTA (CC),
    chunks of chains, tiles of 32 individuals per branch, shared bytes per
    CTA, X tile buffers, scratch bytes and the register width KM."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(K7_PLAN_FIELDS, _k7_plan(index, G, C, m, n, k0, s, depth, grad,
                                             ACT_CODES[act], x_bf16(x_dtype))))


def _vg_chains_cuda(act, xT, weights, biases, target, grad: bool):
    """Launch K7 (csrc/branch_vg_chains.cu) once: with ``grad`` the pass
    and its fixed-order reduce, else the forward-only pass, and no other
    device op (but, on the deep design, the one concatenation of the
    weights). The per-layer weights (first design) and the targets are read
    where they lie (strided over branches and chains, as
    ``predict_chains``' transposed views are). Returns y_pred [G, C, n]
    and, with ``grad``, (rss [G, C], dws, dbs) beside it: views of one
    buffer."""
    dev, xT = xT.device, xT.contiguous()
    xb = _check_x(xT, xT.shape, dev)
    G, C, m, n, k0, s, depth = _dense_shape(xT, weights, vg_chains_smem, "K7")
    code = ACT_CODES[act]
    plan = _k7_plan(dev.index, G, C, m, n, k0, s, depth, grad, code, xb)
    P = _flat_size(m, k0, s, depth)
    out = torch.empty(G * C * (n + P + 1) if grad else G * C * n, dtype=torch.float32, device=dev)
    scratch = (_scratch(dev, ("K7", dev.index, G, C, m, n, k0, s, depth, xb), plan[7]) if grad
               else None)
    vp = ctypes.c_void_p
    if dense_deep(k0, s, depth):  # the weights in their flat layout, one concatenation
        q = flat_params(weights, biases)
        _check(q, "weights", torch.float32, (G, C, P), dev)
        keep, ptrs, strides = pass_instances([(target if grad else None, "target", (G, C, n),
                                               False)], dev)
        status = _build.lib().vg_chains_deep_f32(
            vp(xT.data_ptr()), vp(ptrs[0]), strides[0], strides[1], vp(q.data_ptr()),
            vp(out.data_ptr()), vp(scratch.data_ptr() if grad else 0), plan[7], G, C, m, n, k0,
            s, depth, code, int(grad), xb, vp(_build.stream_ptr(xT)),
        )
        _build.check(status, "vg_chains_deep_f32")
    else:
        keep, ptrs, strides = chain_instances(target if grad else None, weights, biases, dev)
        status = _build.lib().vg_chains_f32(
            vp(xT.data_ptr()), (vp * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides), vp(out.data_ptr()),
            vp(scratch.data_ptr() if grad else 0), plan[7], G, C, m, n, k0, s, depth, code,
            int(grad), xb, vp(_build.stream_ptr(xT)),
        )
        _build.check(status, "vg_chains_f32")
    data_vg_chains.launches += 1
    data_vg_chains.xbf16_launches += xb
    y_pred = out[: G * C * n].view(G, C, n)
    if not grad:
        return y_pred
    o = G * C * n
    dws, dbs = _grad_views(out[o : o + G * C * P].view(G, C, P), (G, C), m, k0, s, depth)
    return y_pred, out[o + G * C * P :].view(G, C), dws, dbs


def data_vg_chains(act_name, xT, weights, biases, target):
    """Chain-folded dense value-and-gradient, same contract as the JAX
    package's ``data_vg_chains(..., f32=True)``: xT [G, m_pad, n];
    weights[l] [G, C, in, out]; biases[l] [G, C, out]; target [G, C, n].
    Returns (y_pred [G, C, n], rss [G, C], dws, dbs) with dW/db =
    d(rss/2)/d(.) in the input layouts. A CPU tensor runs the plain version;
    a CUDA tensor launches K7, the pass and its reduce, rss and all (and
    raises if it cannot)."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return data_vg_chains_ref(act_name, xT, weights, biases, target)
    return _vg_chains_cuda(act_name, xT, weights, biases, target, True)


def forward_chains(act_name, xT, weights, biases) -> torch.Tensor:
    """y_pred [G, C, n] of ``data_vg_chains`` alone: on a CUDA tensor K7's
    forward-only instantiation (one launch, the weights read in place), on
    a CPU tensor ``forward_chains_ref``."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return forward_chains_ref(act_name, xT, weights, biases)
    return _vg_chains_cuda(act_name, xT, weights, biases, None, False)


data_vg_chains.launches = 0  # K7 launches (both instantiations) since the last reset
data_vg_chains.xbf16_launches = 0  # those of them on bf16 X


# ------------------------------------- dense, one instance per X read (K8)


def data_vg_ref(act, xT, weights, biases, target):
    """Plain PyTorch version of K8a: the feature-major forward, autograd for
    the gradients of rss / 2. xT [m_pad, n]; weights[l] [in, out]; biases[l]
    [out]; target [n]. Every tensor may carry the same leading axes (one
    value of rss per leading index). Returns (y_pred, rss, dws, dbs)."""
    ws = [w.detach().requires_grad_(True) for w in weights]
    bs = [b.detach().requires_grad_(True) for b in biases]
    with torch.enable_grad():
        pred = _forward_fm(act, xT, ws, bs)
        rss = torch.sum((pred - target) ** 2, dim=-1)
        grads = torch.autograd.grad(0.5 * torch.sum(rss), ws + bs)
    return pred.detach(), rss.detach(), tuple(grads[: len(ws)]), tuple(grads[len(ws):])


def _gather(X, ix):
    return X if ix is None else X[ix.long()]


def data_vg_blocked_ref(act, X, ix, weights, biases, targets):
    """Plain PyTorch version of K8b: instance i on X[ix[i]] (X[i] when ix is
    None), by ``data_vg_ref`` over the leading [NB] axis."""
    return data_vg_ref(act, _gather(X, ix), weights, biases, targets)


def forward_blocked_ref(act, X, ix, weights, biases) -> torch.Tensor:
    """Plain PyTorch version of K8's forward-only instantiation: y_pred
    [NB, n] of instance i on X[ix[i]]."""
    return _forward_fm(act, _gather(X, ix), weights, biases)


K8_PLAN_FIELDS = ("ctas", "tiles", "smem", "ctas_per_sm", "buffers", "slots", "scratch", "km")


@functools.lru_cache(maxsize=None)
def _k8_plan(device_index: int, NB: int, m: int, n: int, k0: int, s: int, depth: int,
             grad: bool, act: int, xb: int = 0) -> tuple:
    out = (ctypes.c_longlong * len(K8_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().vg_dense_plan(NB, m, n, k0, s, depth, int(grad), act, xb, out),
                     "vg_dense_plan")
    return tuple(out)


def vg_dense_plan(NB: int, m: int, n: int, k0: int, s: int, depth: int, grad: bool = True,
                  act: str = "tanh", device=None, x_dtype=torch.float32) -> dict:
    """What a K8 launch for NB instances on X of m_pad markers and n
    individuals, stored in ``x_dtype``, under ``act`` uses on a CUDA device
    (the current one by default; each activation is its own instantiation):
    CTAs in the grid, tiles of 32 individuals per instance, shared bytes per
    CTA, resident CTAs per SM, X tile buffers, partial-row slots, scratch
    bytes and the register width KM."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(K8_PLAN_FIELDS, _k8_plan(index, NB, m, n, k0, s, depth, grad,
                                             ACT_CODES[act], x_bf16(x_dtype))))


def _vg_dense_cuda(act, X, ix, weights, biases, targets, grad: bool):
    """Launch csrc/branch_vg_dense.cu for NB instances, X [G, m_pad, n] and
    weights[l] [NB, in, out] (instance i on X[ix[i]]), or for one, xT
    [m_pad, n] and weights[l] [in, out]: with ``grad`` the pass and its
    reduce, else the forward-only pass, and no other device op (but, on the
    deep design, the one concatenation of the weights). Returns
    (y_pred, rss, dws, dbs) with ``grad``, else y_pred, each shaped as its
    inputs (a leading [NB] or none): views of one buffer."""
    lead = X.dim() == 3
    G, (m, n) = X.shape[0] if lead else 1, X.shape[-2:]
    NB, depth = weights[0].shape[0] if lead else 1, len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    if vg_dense_smem(m, k0, s, depth, X.dtype) < 0:
        raise NotImplementedError(
            f"the K8 CUDA kernel takes padded layer widths up to 64 within 227 KB of shared "
            f"memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )
    dev, pre = X.device, (NB,) if lead else ()
    X = X.contiguous()  # each of these is itself when contiguous: no copy on the main paths
    xb = _check_x(X, (G, m, n) if lead else (m, n), dev)
    ws = [w.contiguous() for w in weights]
    bs = [b.contiguous() for b in biases]
    dims = [(i, o) for i, o in _dims(m, k0, s, depth)] + [(s, 1)]
    for l, w in enumerate(ws):
        _check(w, f"weights[{l}]", torch.float32, pre + dims[l], dev)
    for l, b in enumerate(bs):
        _check(b, f"biases[{l}]", torch.float32, pre + (dims[l][1],), dev)
    if ix is None:
        if NB != G:
            raise ValueError(f"{NB} instances on {G} branches need an index")
    else:
        _check(ix, "ix", torch.int32, (NB,), dev)
    if grad:
        targets = targets.contiguous()
        _check(targets, "targets", torch.float32, pre + (n,), dev)
    code = ACT_CODES[act]
    nbytes = _k8_plan(dev.index, NB, m, n, k0, s, depth, grad, code, xb)[6]  # scratch bytes
    P = _flat_size(m, k0, s, depth)
    out = torch.empty(NB * (n + P + 1) if grad else NB * n, dtype=torch.float32, device=dev)
    scratch = (_scratch(dev, ("K8", dev.index, NB, m, n, k0, s, depth, xb), nbytes) if grad
               else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    if dense_deep(k0, s, depth):  # the weights in their flat layout, one concatenation
        q = flat_params(ws, bs)
        status = _build.lib().vg_dense_deep_f32(
            X.data_ptr(), ptr(ix), ptr(targets if grad else None), q.data_ptr(), out.data_ptr(),
            ptr(scratch), nbytes, NB, m, n, k0, s, depth, code, int(grad), xb,
            _build.stream_ptr(X),
        )
        _build.check(status, "vg_dense_deep_f32")
    else:
        status = _build.lib().vg_dense_f32(
            X.data_ptr(), ptr(ix), ptr(targets if grad else None), ws[0].data_ptr(),
            bs[0].data_ptr(), ptr(ws[1] if depth else None), ptr(bs[1] if depth else None),
            ws[-1].data_ptr(), out.data_ptr(), ptr(scratch), nbytes, NB, m, n, k0, s, depth,
            code, int(grad), xb, _build.stream_ptr(X),
        )
        _build.check(status, "vg_dense_f32")
    y_pred = out[: NB * n].view(pre + (n,))
    if not grad:
        return y_pred
    # [NB, P] gradients in the kernels' flat layout, then rss
    o = NB * n
    dws, dbs = _grad_views(out[o : o + NB * P].view(pre + (P,)), pre, m, k0, s, depth)
    rss = out[o + NB * P :] if lead else out[o + P]
    return y_pred, rss, dws, dbs


def data_vg_blocked(act_name, X, ix, weights, biases, targets):
    """Dense value-and-gradient of NB independent instances, the JAX
    package's ``data_vg`` under a vmap (K8b): instance i of weights[l]
    [NB, in, out], biases[l] [NB, out] and targets [NB, n] on X[ix[i]] of
    feature-major X [G, m_pad, n] (X[i] when ix is None; ix int32 on the
    card), read in place. Returns (y_pred [NB, n], rss [NB], dws, dbs) with
    dW/db = d(rss/2)/d(.) in the input layouts. A CPU tensor runs
    ``data_vg_blocked_ref``; a CUDA tensor launches csrc/branch_vg_dense.cu
    (and raises if it cannot), rss and all."""
    _check_act(act_name)
    if X.device.type == "cpu":
        return data_vg_blocked_ref(act_name, X, ix, weights, biases, targets)
    out = _vg_dense_cuda(act_name, X, ix, weights, biases, targets, True)
    data_vg_blocked.launches += 1
    data_vg_blocked.xbf16_launches += X.dtype == torch.bfloat16
    return out


def data_vg(act_name, xT, weights, biases, target):
    """Dense value-and-gradient of one branch, the JAX package's ``data_vg``
    unvmapped (K8a): xT [m_pad, n] (FeatX.xT); weights[l] [in, out];
    biases[l] [out]; target [n]. Returns (y_pred [n], rss, dws, dbs) with
    dW/db = d(rss/2)/d(.) in the input layouts. A CPU tensor runs
    ``data_vg_ref``; a CUDA tensor launches csrc/branch_vg_dense.cu with one
    instance (and raises if it cannot), rss and all."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return data_vg_ref(act_name, xT, weights, biases, target)
    out = _vg_dense_cuda(act_name, xT, None, weights, biases, target, True)
    data_vg.launches += 1
    data_vg.xbf16_launches += xT.dtype == torch.bfloat16
    return out


def forward_blocked(act_name, X, ix, weights, biases) -> torch.Tensor:
    """y_pred [NB, n] of ``data_vg_blocked`` alone: on a CUDA tensor K8's
    forward-only instantiation, on a CPU tensor ``forward_blocked_ref``."""
    _check_act(act_name)
    if X.device.type == "cpu":
        return forward_blocked_ref(act_name, X, ix, weights, biases)
    y_pred = _vg_dense_cuda(act_name, X, ix, weights, biases, None, False)
    forward_blocked.launches += 1
    forward_blocked.xbf16_launches += X.dtype == torch.bfloat16
    return y_pred


data_vg.launches = 0  # K8a launches since the last reset
data_vg_blocked.launches = 0  # K8b launches since the last reset
forward_blocked.launches = 0  # forward-only K8 launches since the last reset
# those of them on bf16 X (x_bf16 = 1)
data_vg.xbf16_launches = data_vg_blocked.xbf16_launches = forward_blocked.xbf16_launches = 0
