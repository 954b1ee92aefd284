"""Chain-folded whole-trajectory leapfrog on packed genotypes (K5) and on
dense feature-major X (K6).

Counterpart of rs_bann_tpu/ops/leapfrog.py ``integrate_chains_packed`` and
``integrate_chains``: for every (branch b of a block, chain c) they
integrate L leapfrog steps

    p += eps/2 * g;   q += eps * p;   g = grad ld(q);   p += eps/2 * g

of ld(q) = prior(q) - err[b, c] * rss(q) / 2, whose prior gradient is
-lam * q, or -lam * sign(q) with sign(0) = 0 under ``l1``. On the packed
path the genotypes stay 2-bit packed and are standardized as
(g - mu) * scale; the dense path takes standardized xT [B, m_pad, n].

Layouts carry an explicit chain axis: bytes [B, m_pad, Bytes] and
w_scale / shift [B, m_pad] (a block PackedX), targets [B, C, n] in natural
individual order, err [B, C], and weights, momenta, step sizes and prior
precision factors per layer [B, C, in, out] (biases [B, C, out]).

On a CUDA tensor one call is one launch of csrc/traj_packed.cu (K5) or
csrc/traj_dense.cu (K6); on a CPU tensor it runs the plain PyTorch version
the kernel is held against (``integrate_chains_packed_ref``,
``integrate_chains_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .activations import ACT_CODES
from .branch_mlp import (
    SUPPORTED_ACTIVATIONS,
    DENSE_TILE,
    _dense_shape,
    data_vg_chains_ref,
    flat_params,
    unflat_params,
)
from .packed_matmul import GBYTES, _check, unpack_strided


def integrate_chains_packed_ref(
    act, bytes_g, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b, L_steps, n, l1=False,
):
    """Plain PyTorch version of K5: decode and standardize once, then the
    plain version of K6 on the standardized feature-major genotypes.
    Returns (w_L, b_L, pw_L, pb_L)."""
    dec = unpack_strided(bytes_g, n)  # [B, m, n]
    xT = dec * w_scale[..., None] - (shift * w_scale)[..., None]
    return integrate_chains_ref(act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b,
                                lam_w, lam_b, L_steps, l1)


def live_width(k0: int, w, pw, eps, lam) -> int:
    """Live layer-0 width of a depth-0 block: 1 + the last column of W0 [m,
    k0], b0 [k0] or w_out [k0], over (branch, chain, row), with a nonzero
    position ``w`` or momentum ``pw``, or a step size ``eps`` or prior
    precision ``lam`` that is not finite (flat_params layouts [nb, C,
    (m + 2) * k0]). Every activation has act(0) = 0, so a column past it
    adds nothing to any prediction, its gradient is zero, and the leapfrog
    leaves it exactly as it is whatever its (finite) step size: the padded
    columns, whose weights and momenta are masked to zero. One reduction on
    the device and one host read."""
    live = (w.ne(0) | pw.ne(0) | ~eps.isfinite() | ~lam.isfinite()).reshape(-1, k0).any(0)
    cols = torch.arange(1, k0 + 1, device=live.device)
    return int(torch.where(live, cols, 0).max().item())


def _integrate_packed_cuda(
    act, bytes_g, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b, L_steps, n, l1,
):
    """Launch csrc/traj_packed.cu once for the whole block and trajectory.
    At depth 0 the kernel computes only the block's live columns
    (``live_width``); the others it leaves as they are."""
    nb, m, B = bytes_g.shape
    C = targets.shape[1]
    depth = len(weights) - 2
    k0 = weights[0].shape[-1]
    s = weights[-1].shape[-2]
    dev = bytes_g.device
    if B % GBYTES or n > 4 * B or n <= 0:
        raise ValueError(f"bad packed shape: B={B}, n={n}")
    lib = _build.lib()
    if lib.traj_packed_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K5 CUDA kernel takes depth 0 or 1 and layer widths up to 32 "
            f"within 227 KB of shared memory; got depth={depth}, m={m}, "
            f"k0={k0}, s={s}"
        )
    w, pw = flat_params(weights, biases), flat_params(p_w, p_b)
    eps, lam = flat_params(eps_w, eps_b), flat_params(lam_w, lam_b)
    P = w.shape[-1]
    k_live = live_width(k0, w, pw, eps, lam) if depth == 0 else k0
    scale, shift = w_scale.contiguous(), shift.contiguous()
    targets, err = targets.contiguous(), err.contiguous()
    _check(bytes_g, "bytes", torch.uint8, (nb, m, B), dev)
    _check(scale, "w_scale", torch.float32, (nb, m), dev)
    _check(shift, "shift", torch.float32, (nb, m), dev)
    _check(targets, "targets", torch.float32, (nb, C, n), dev)
    _check(err, "err", torch.float32, (nb, C), dev)
    for name, t in (("weights", w), ("momenta", pw), ("eps", eps), ("lam", lam)):
        _check(t, name, torch.float32, (nb, C, P), dev)
    partial = torch.empty((nb, C, B // GBYTES, P), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = lib.traj_packed_f32(
        vp(bytes_g.data_ptr()), vp(scale.data_ptr()), vp(shift.data_ptr()),
        vp(targets.data_ptr()), vp(err.data_ptr()), vp(eps.data_ptr()),
        vp(lam.data_ptr()), vp(w.data_ptr()), vp(pw.data_ptr()),
        vp(partial.data_ptr()), nb, C, m, B, n, k0, k_live, s, P, depth, int(L_steps),
        ACT_CODES[act], int(bool(l1)), vp(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "traj_packed_f32")
    integrate_chains_packed.launches += 1
    w_f, b_f = unflat_params(w, weights, biases)
    pw_f, pb_f = unflat_params(pw, weights, biases)
    return w_f, b_f, pw_f, pb_f


def integrate_chains_packed(
    act_name, bytes_g, w_scale, shift, targets, err, weights, biases,
    p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps, n, l1=False,
):
    """Integrate L leapfrog steps for all (branch, chain) pairs of a block,
    same contract as the JAX package's (layouts in the module docstring).
    Returns (w_L, b_L, pw_L, pb_L). A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (and raises if it cannot)."""
    if act_name not in SUPPORTED_ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act_name}")
    fn = integrate_chains_packed_ref if bytes_g.device.type == "cpu" else _integrate_packed_cuda
    return fn(act_name, bytes_g, w_scale, shift, targets, err, weights, biases,
              p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps, n, l1)


integrate_chains_packed.launches = 0  # kernel launches since the last reset


def integrate_chains_ref(
    act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps,
    l1=False,
):
    """Plain PyTorch version of K6: L leapfrog steps whose data gradients
    come from ``data_vg_chains_ref`` (autograd of the feature-major
    forward). Returns (w_L, b_L, pw_L, pb_L)."""
    e4, e3 = err[:, :, None, None], err[:, :, None]

    def ld_grad(ws, bs):
        dws, dbs = data_vg_chains_ref(act, xT, ws, bs, targets)[2:]
        gw = tuple(-lam * (torch.sign(w) if l1 else w) - e4 * d
                   for w, lam, d in zip(ws, lam_w, dws))
        gb = tuple(-lam * (torch.sign(b) if l1 else b) - e3 * d
                   for b, lam, d in zip(bs, lam_b, dbs))
        return gw, gb

    def kick(ps, eps, gs):
        return tuple(p + 0.5 * e * g for p, e, g in zip(ps, eps, gs))

    ws, bs, pws, pbs = tuple(weights), tuple(biases), tuple(p_w), tuple(p_b)
    gw, gb = ld_grad(ws, bs)
    for _ in range(L_steps):
        pws, pbs = kick(pws, eps_w, gw), kick(pbs, eps_b, gb)
        ws = tuple(w + e * p for w, e, p in zip(ws, eps_w, pws))
        bs = tuple(b + e * p for b, e, p in zip(bs, eps_b, pbs))
        gw, gb = ld_grad(ws, bs)
        pws, pbs = kick(pws, eps_w, gw), kick(pbs, eps_b, gb)
    return ws, bs, pws, pbs


def _integrate_dense_cuda(
    act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps, l1,
):
    """Launch csrc/traj_dense.cu once for the whole trajectory."""
    G, C, m, n, k0, s, depth = _dense_shape(xT, weights)
    dev = xT.device
    lib = _build.lib()
    w, pw = flat_params(weights, biases), flat_params(p_w, p_b)
    eps, lam = flat_params(eps_w, eps_b), flat_params(lam_w, lam_b)
    P = w.shape[-1]
    xT, targets, err = xT.contiguous(), targets.contiguous(), err.contiguous()
    _check(xT, "xT", torch.float32, (G, m, n), dev)
    _check(targets, "targets", torch.float32, (G, C, n), dev)
    _check(err, "err", torch.float32, (G, C), dev)
    for name, t in (("weights", w), ("momenta", pw), ("eps", eps), ("lam", lam)):
        _check(t, name, torch.float32, (G, C, P), dev)
    partial = torch.empty((G, C, -(-n // DENSE_TILE), P), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = lib.traj_dense_f32(
        vp(xT.data_ptr()), vp(targets.data_ptr()), vp(err.data_ptr()), vp(eps.data_ptr()),
        vp(lam.data_ptr()), vp(w.data_ptr()), vp(pw.data_ptr()), vp(partial.data_ptr()),
        G, C, m, n, k0, s, P, depth, int(L_steps), ACT_CODES[act], int(bool(l1)),
        vp(_build.stream_ptr(xT)),
    )
    _build.check(status, "traj_dense_f32")
    integrate_chains.launches += 1
    w_f, b_f = unflat_params(w, weights, biases)
    pw_f, pb_f = unflat_params(pw, weights, biases)
    return w_f, b_f, pw_f, pb_f


def integrate_chains(
    act_name, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b,
    L_steps, l1=False,
):
    """Integrate L leapfrog steps for all (branch, chain) pairs on dense
    feature-major X, same contract as the JAX package's: xT [G, m_pad, n];
    targets [G, C, n]; err [G, C]; weights, momenta, step sizes and prior
    precision factors per layer [G, C, in, out] (biases [G, C, out]).
    Returns (w_L, b_L, pw_L, pb_L). A CPU tensor runs the plain version; a
    CUDA tensor launches K6 (and raises if it cannot)."""
    if act_name not in SUPPORTED_ACTIVATIONS:
        raise ValueError(f"unsupported activation: {act_name}")
    fn = integrate_chains_ref if xT.device.type == "cpu" else _integrate_dense_cuda
    return fn(act_name, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b,
              L_steps, l1)


integrate_chains.launches = 0  # K6 launches since the last reset
