"""Fused packed value-and-gradient of one leapfrog step's data term (K4).

Counterpart of rs_bann_tpu/ops/branch_mlp.py ``data_vg_packed``. For one
branch network f(x; W, b) on 2-bit packed genotypes it returns

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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply
from .packed_matmul import GBYTES, _check, unpack_strided

SUPPORTED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh", "silu")


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
    if act_name not in SUPPORTED_ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act_name}")
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
