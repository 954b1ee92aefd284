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
csrc/branch_vg_packed.cu (depth 0 and 1, every activation); on a CPU tensor
it is ``data_vg_packed_ref``: decode with ``unpack_strided``, dense forward,
autograd for the gradients.

``data_vg_chains`` computes the same for every (branch g, chain c) of
feature-major X xT [G, m_pad, n] (models/density.py ``FeatX``), weights[l]
[G, C, in, out], biases[l] [G, C, out] and targets [G, C, n]: one X read
serves all C chains. On a CUDA tensor it is csrc/branch_vg_chains.cu (depth
0 and 1, widths up to 32, every activation); ``forward_chains`` is the
kernel's forward-only instantiation (y_pred alone), which the folded
transition's value passes use. On a CPU tensor both run their plain
versions (``data_vg_chains_ref``, ``forward_chains_ref``). Both count their
launches in ``data_vg_chains.launches``.

``data_vg`` is the same for one branch and one chain (xT [m_pad, n]: the
sequential schedule's leapfrog step, K8a), ``data_vg_blocked`` for NB
independent instances, instance i on X[ix[i]] of X [G, m_pad, n] read in
place (every (chain, branch) of an unfolded hybrid block, K8b), and
``forward_blocked`` its y_pred alone. On a CUDA tensor all three are
csrc/branch_vg_dense.cu (K7's device code at one chain; the limits of K6
and K7), each counting its own launches; on a CPU tensor their plain
versions (``data_vg_ref``: autograd of the feature-major forward).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply
from .packed_matmul import GBYTES, _check, unpack_strided

SUPPORTED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh", "silu")


def _check_act(act_name):
    if act_name not in SUPPORTED_ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act_name}")


def data_vg_packed_ref(act, bytes_mb, target, weights, biases, n: int):
    """Plain PyTorch version of K4 on pre-folded weights, one branch.

    bytes [m, B] u8; target [n]; weights (W0' [m, k0], ..., w_out [s, 1]);
    biases (off [k0], ...). Returns (y_pred [n], dws, dbs) with the
    gradients of rss / 2 in the folded coordinates.
    """
    ws = [w.detach().requires_grad_(True) for w in weights]
    bs = [b.detach().requires_grad_(True) for b in biases]
    with torch.enable_grad():
        a = unpack_strided(bytes_mb, n).transpose(0, 1)  # [n, m]
        for l in range(len(ws) - 1):
            a = _act_apply(act, a @ ws[l] + bs[l][None, :])
        pred = (a @ ws[-1])[:, 0]
        half_rss = 0.5 * torch.sum((pred - target) ** 2)
        grads = torch.autograd.grad(half_rss, ws + bs)
    return pred.detach(), tuple(grads[: len(ws)]), tuple(grads[len(ws):])


def _data_vg_packed_cuda(act, bytes_mb, target, weights, biases, n: int):
    """Launch csrc/branch_vg_packed.cu for one branch (folded weights)."""
    depth = len(weights) - 2
    m, B = bytes_mb.shape
    k0 = weights[0].shape[1]
    s = weights[-1].shape[0]
    dev = bytes_mb.device
    if B % GBYTES or n > 4 * B or n <= 0:
        raise ValueError(f"bad packed shape: B={B}, n={n}")
    lib = _build.lib()
    if lib.branch_vg_packed_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K4 CUDA kernel takes depth 0 or 1 and layer widths up to 32 "
            f"within 227 KB of shared memory; got depth={depth}, m={m}, "
            f"k0={k0}, s={s}"
        )
    w0 = weights[0].contiguous()
    b0 = biases[0].contiguous()
    wout = weights[-1].reshape(s).contiguous()
    if depth == 1:
        w1, b1 = weights[1].contiguous(), biases[1].contiguous()
        _check(w1, "w1", torch.float32, (k0, s), dev)
        _check(b1, "b1", torch.float32, (s,), dev)
    else:
        w1 = b1 = wout  # unused by the depth-0 kernel
    _check(bytes_mb, "bytes", torch.uint8, (m, B), dev)
    _check(target, "target", torch.float32, (n,), dev)
    _check(w0, "w0", torch.float32, (m, k0), dev)
    _check(b0, "b0", torch.float32, (k0,), dev)
    _check(wout, "w_out", torch.float32, (s,), dev)
    P = m * k0 + k0 + (k0 * s + s if depth == 1 else 0) + s
    y_pred = torch.empty(n, dtype=torch.float32, device=dev)
    partial = torch.empty((B // GBYTES, P), dtype=torch.float32, device=dev)
    grads = torch.empty(P, dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = lib.branch_vg_packed_f32(
        vp(bytes_mb.data_ptr()), vp(target.data_ptr()), vp(w0.data_ptr()),
        vp(b0.data_ptr()), vp(w1.data_ptr()), vp(b1.data_ptr()),
        vp(wout.data_ptr()), vp(y_pred.data_ptr()), vp(partial.data_ptr()),
        vp(grads.data_ptr()), 1, m, B, n, k0, s, P, depth, ACT_CODES[act],
        vp(_build.stream_ptr(bytes_mb)),
    )
    _build.check(status, "branch_vg_packed_f32")
    data_vg_packed.launches += 1
    dW0 = grads[: m * k0].view(m, k0)
    db0 = grads[m * k0 : m * k0 + k0]
    ix = m * k0 + k0
    dws, dbs = [dW0], [db0]
    if depth == 1:
        dws.append(grads[ix : ix + k0 * s].view(k0, s))
        dbs.append(grads[ix + k0 * s : ix + k0 * s + s])
        ix += k0 * s + s
    dws.append(grads[ix : ix + s].view(s, 1))
    return y_pred, tuple(dws), tuple(dbs)


def data_vg_packed(act_name, x, weights, biases, target):
    """Fused packed value-and-gradient for one branch, same contract as the
    JAX package's: ``x`` is a single-branch PackedX (models/density.py),
    ``weights``/``biases`` the branch's layers in the stacked layout.

    Returns (y_pred [n], rss, dws, dbs): the data term's prediction, rss and
    the gradients of rss / 2.
    """
    _check_act(act_name)
    s = x.w_scale
    w0p = s[:, None] * weights[0]
    off = biases[0] - x.shift @ w0p
    wf = (w0p,) + tuple(weights[1:])
    bf = (off,) + tuple(biases[1:])
    if x.bytes.device.type == "cpu":
        y_pred, dws, dbs = data_vg_packed_ref(act_name, x.bytes, target, wf, bf, x.n)
    else:
        y_pred, dws, dbs = _data_vg_packed_cuda(act_name, x.bytes, target, wf, bf, x.n)
    rss = torch.sum((y_pred - target) ** 2)
    dW0 = s[:, None] * dws[0] - (x.shift * s)[:, None] * dbs[0]
    return y_pred, rss, (dW0,) + tuple(dws[1:]), dbs


data_vg_packed.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------ dense chains (K7)

DENSE_TILE = 128  # individuals per K6/K7 work item (csrc/dense_chain_mlp.cuh kTile)
_DENSE_ROW = DENSE_TILE + 4  # shared-memory row stride (kRowT)
_MAX_SMEM = 232448  # dynamic shared memory a block may use


def dense_chains_smem(m: int, k0: int, s: int, depth: int) -> int:
    """Shared memory (bytes) that K6, K7 and K8 need for one branch of m_pad
    markers and layer widths k0, s, or -1 if they cannot run it (depth above
    1, a width above 32, or more than 227 KB). The same rule as the CUDA
    entry point ``dense_chains_smem``; the CLI asks it before training on
    the card."""
    w = max(k0, s)
    km = next((k for k in (8, 16, 32) if w <= k), -1)
    if km < 0 or depth not in (0, 1) or m <= 0:
        return -1
    floats = m * _DENSE_ROW + 3 * km * _DENSE_ROW + m * km + 2 * km * km + 4 * km + DENSE_TILE
    return 4 * floats if 4 * floats <= _MAX_SMEM else -1


_PACKED_ROW = GBYTES + 4  # shared-memory row stride of K4's and K5's byte tile (kRow)


def _packed_smem(m: int, k0: int, s: int, depth: int, extra_floats: int) -> int:
    """The rule K4 and K5 share: register width KM from ``pick_km``
    (csrc/packed_decode.cuh), depth 0 or 1, the weights and one [512, KM + 4]
    row tile per saved per-individual row (three at depth 1), the byte tile,
    within 227 KB. ``extra_floats`` is what the kernel adds of its own."""
    km = next((k for k in (8, 16, 32) if max(k0, s) <= k), -1)
    if km < 0 or depth not in (0, 1):
        return -1
    deep = depth == 1
    floats = (4 * GBYTES * (km + 4) * (3 if deep else 1) + m * km + km
              + (km * km + km if deep else 0) + km + 4 * km + extra_floats)
    smem = 4 * floats + m * _PACKED_ROW
    return smem if smem <= _MAX_SMEM else -1


def branch_vg_packed_smem(m: int, k0: int, s: int, depth: int) -> int:
    """Shared memory (bytes) K4 needs for one branch of m_pad markers and
    padded widths k0, s, or -1 if it cannot run it. The rule of the CUDA
    entry point of the same name; the CLI asks it before a packed HMC run on
    the card whose branches step one by one."""
    return _packed_smem(m, k0, s, depth, 0)


def traj_packed_smem(m: int, k0: int, s: int, depth: int) -> int:
    """Shared memory (bytes) K5 needs at the padded widths, or -1 if it
    cannot run them: K4's rule plus each marker's scale and offset. The rule
    of the CUDA entry point of the same name; the CLI asks it before a
    folded packed HMC run on the card. (K5 computes only a block's live
    columns, which never need more.)"""
    return _packed_smem(m, k0, s, depth, 2 * m)


def flat_params(weights, biases) -> torch.Tensor:
    """Per-layer [G, C, ...] tensors -> [G, C, P] in the kernels' layout:
    W0, b0, (W1, b1), w_out."""
    nb, C = weights[0].shape[:2]
    parts = []
    for w, b in zip(weights[:-1], biases):
        parts += [w.reshape(nb, C, -1), b.reshape(nb, C, -1)]
    parts.append(weights[-1].reshape(nb, C, -1))
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
    width-1 output as a sum over the summary rows. xT [..., m_pad, n],
    weights[l] [..., in, out] -> y_pred [..., n] (models/density.py
    ``forward`` on a FeatX)."""
    a = xT
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


def _dense_shape(xT, weights):
    G, m, n = xT.shape
    depth = len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    if dense_chains_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K6/K7 CUDA kernels take depth 0 or 1 and layer widths up to 32 "
            f"within 227 KB of shared memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )
    return G, weights[0].shape[1], m, n, k0, s, depth


def _vg_chains_cuda(act, xT, weights, biases, target, grad: bool):
    """Launch csrc/branch_vg_chains.cu once (plus its fixed-order tile sum
    when ``grad``). Returns y_pred [G, C, n] and, with ``grad``, the flat
    gradients [G, C, P]."""
    G, C, m, n, k0, s, depth = _dense_shape(xT, weights)
    dev = xT.device
    lib = _build.lib()
    q = flat_params(weights, biases)
    P = q.shape[-1]
    _check(xT, "xT", torch.float32, (G, m, n), dev)
    _check(q, "weights", torch.float32, (G, C, P), dev)
    y_pred = torch.empty((G, C, n), dtype=torch.float32, device=dev)
    partial = grads = None
    if grad:
        _check(target, "target", torch.float32, (G, C, n), dev)
        partial = torch.empty((G, C, -(-n // DENSE_TILE), P), dtype=torch.float32, device=dev)
        grads = torch.empty((G, C, P), dtype=torch.float32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    status = lib.vg_chains_f32(
        ptr(xT), ptr(target if grad else None), ptr(q), ptr(y_pred), ptr(partial), ptr(grads),
        G, C, m, n, k0, s, P, depth, ACT_CODES[act], int(grad),
        ctypes.c_void_p(_build.stream_ptr(xT)),
    )
    _build.check(status, "vg_chains_f32")
    data_vg_chains.launches += 1
    return y_pred, grads


def data_vg_chains(act_name, xT, weights, biases, target):
    """Chain-folded dense value-and-gradient, same contract as the JAX
    package's ``data_vg_chains(..., f32=True)``: xT [G, m_pad, n];
    weights[l] [G, C, in, out]; biases[l] [G, C, out]; target [G, C, n].
    Returns (y_pred [G, C, n], rss [G, C], dws, dbs) with dW/db =
    d(rss/2)/d(.) in the input layouts. A CPU tensor runs the plain version;
    a CUDA tensor launches K7 (and raises if it cannot)."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return data_vg_chains_ref(act_name, xT, weights, biases, target)
    target = target.contiguous()
    y_pred, grads = _vg_chains_cuda(act_name, xT.contiguous(), weights, biases, target, True)
    dws, dbs = unflat_params(grads, weights, biases)
    return y_pred, torch.sum((y_pred - target) ** 2, dim=-1), dws, dbs


def forward_chains(act_name, xT, weights, biases) -> torch.Tensor:
    """y_pred [G, C, n] of ``data_vg_chains`` alone: on a CUDA tensor K7's
    forward-only instantiation, on a CPU tensor ``forward_chains_ref``."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return forward_chains_ref(act_name, xT, weights, biases)
    return _vg_chains_cuda(act_name, xT.contiguous(), weights, biases, None, False)[0]


data_vg_chains.launches = 0  # K7 launches (both instantiations) since the last reset


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


def _vg_dense_cuda(act, X, ix, weights, biases, targets, grad: bool):
    """Launch csrc/branch_vg_dense.cu once (plus its fixed-order tile sum
    when ``grad``) for NB instances: weights[l] [NB, in, out], instance i on
    X[ix[i]]. Returns y_pred [NB, n] and, with ``grad``, the flat gradients
    [NB, P]."""
    G, m, n = X.shape
    NB, depth = weights[0].shape[0], len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    if dense_chains_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K8 CUDA kernel takes depth 0 or 1 and layer widths up to 32 "
            f"within 227 KB of shared memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )
    dev = X.device
    lib = _build.lib()
    q = flat_params(tuple(w.unsqueeze(1) for w in weights),
                    tuple(b.unsqueeze(1) for b in biases))
    P = q.shape[-1]
    _check(X, "X", torch.float32, (G, m, n), dev)
    _check(q, "weights", torch.float32, (NB, 1, P), dev)
    if ix is None:
        if NB != G:
            raise ValueError(f"{NB} instances on {G} branches need an index")
    else:
        ix = ix.to(torch.int32).contiguous()
        _check(ix, "ix", torch.int32, (NB,), dev)
    y_pred = torch.empty((NB, n), dtype=torch.float32, device=dev)
    partial = grads = None
    if grad:
        _check(targets, "targets", torch.float32, (NB, n), dev)
        partial = torch.empty((NB, -(-n // DENSE_TILE), P), dtype=torch.float32, device=dev)
        grads = torch.empty((NB, P), dtype=torch.float32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    status = lib.vg_dense_f32(
        ptr(X), ptr(ix), ptr(targets if grad else None), ptr(q), ptr(y_pred), ptr(partial),
        ptr(grads), NB, m, n, k0, s, P, depth, ACT_CODES[act], int(grad),
        ctypes.c_void_p(_build.stream_ptr(X)),
    )
    _build.check(status, "vg_dense_f32")
    return y_pred, grads


def _unflat_blocked(grads, weights, biases):
    """Flat gradients [NB, P] -> views shaped as the [NB, ...] weights and biases."""
    dws, dbs = unflat_params(grads[:, None], tuple(w.unsqueeze(1) for w in weights),
                             tuple(b.unsqueeze(1) for b in biases))
    return tuple(d[:, 0] for d in dws), tuple(d[:, 0] for d in dbs)


def data_vg_blocked(act_name, X, ix, weights, biases, targets):
    """Dense value-and-gradient of NB independent instances, the JAX
    package's ``data_vg`` under a vmap (K8b): instance i of weights[l]
    [NB, in, out], biases[l] [NB, out] and targets [NB, n] on X[ix[i]] of
    feature-major X [G, m_pad, n] (X[i] when ix is None), read in place.
    Returns (y_pred [NB, n], rss [NB], dws, dbs) with dW/db = d(rss/2)/d(.)
    in the input layouts. A CPU tensor runs ``data_vg_blocked_ref``; a CUDA
    tensor launches csrc/branch_vg_dense.cu (and raises if it cannot)."""
    _check_act(act_name)
    if X.device.type == "cpu":
        return data_vg_blocked_ref(act_name, X, ix, weights, biases, targets)
    targets = targets.contiguous()
    y_pred, grads = _vg_dense_cuda(act_name, X.contiguous(), ix, weights, biases, targets, True)
    data_vg_blocked.launches += 1
    dws, dbs = _unflat_blocked(grads, weights, biases)
    return y_pred, torch.sum((y_pred - targets) ** 2, dim=-1), dws, dbs


def data_vg(act_name, xT, weights, biases, target):
    """Dense value-and-gradient of one branch, the JAX package's ``data_vg``
    unvmapped (K8a): xT [m_pad, n] (FeatX.xT); weights[l] [in, out];
    biases[l] [out]; target [n]. Returns (y_pred [n], rss, dws, dbs) with
    dW/db = d(rss/2)/d(.) in the input layouts. A CPU tensor runs
    ``data_vg_ref``; a CUDA tensor launches csrc/branch_vg_dense.cu with one
    instance (and raises if it cannot)."""
    _check_act(act_name)
    if xT.device.type == "cpu":
        return data_vg_ref(act_name, xT, weights, biases, target)
    target = target.contiguous()
    weights, biases = tuple(w[None] for w in weights), tuple(b[None] for b in biases)
    y_pred, grads = _vg_dense_cuda(act_name, xT.contiguous()[None], None, weights, biases,
                                   target[None], True)
    data_vg.launches += 1
    dws, dbs = _unflat_blocked(grads, weights, biases)
    return (y_pred[0], torch.sum((y_pred[0] - target) ** 2), tuple(d[0] for d in dws),
            tuple(d[0] for d in dbs))


def forward_blocked(act_name, X, ix, weights, biases) -> torch.Tensor:
    """y_pred [NB, n] of ``data_vg_blocked`` alone: on a CUDA tensor K8's
    forward-only instantiation, on a CPU tensor ``forward_blocked_ref``."""
    _check_act(act_name)
    if X.device.type == "cpu":
        return forward_blocked_ref(act_name, X, ix, weights, biases)
    y_pred = _vg_dense_cuda(act_name, X.contiguous(), ix, weights, biases, None, False)[0]
    forward_blocked.launches += 1
    return y_pred


data_vg.launches = 0  # K8a launches since the last reset
data_vg_blocked.launches = 0  # K8b launches since the last reset
forward_blocked.launches = 0  # forward-only K8 launches since the last reset
