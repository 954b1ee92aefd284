"""Chain-folded whole-trajectory leapfrog on packed genotypes (K5).

Counterpart of rs_bann_tpu/ops/leapfrog.py ``integrate_chains_packed``: for
every (branch b of a block, chain c) it integrates L leapfrog steps

    p += eps/2 * g;   q += eps * p;   g = grad ld(q);   p += eps/2 * g

of ld(q) = prior(q) - err[b, c] * rss(q) / 2, whose prior gradient is
-lam * q, or -lam * sign(q) with sign(0) = 0 under ``l1``. The genotypes
stay 2-bit packed and are standardized as (g - mu) * scale.

Layouts carry an explicit chain axis: bytes [B, m_pad, Bytes] and
w_scale / shift [B, m_pad] (a block PackedX), targets [B, C, n] in natural
individual order, err [B, C], and weights, momenta, step sizes and prior
precision factors per layer [B, C, in, out] (biases [B, C, out]).

On a CUDA tensor one call is one launch of csrc/traj_packed.cu; on a CPU
tensor it runs ``integrate_chains_packed_ref``, the plain PyTorch version
the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply
from .branch_mlp import SUPPORTED_ACTIVATIONS
from .packed_matmul import GBYTES, _check, unpack_strided


def _data_grad(act, xT, targets, weights, biases):
    """d(rss/2)/d(weights, biases) per (branch, chain), by autograd.

    xT [B, n, m] standardized genotypes; targets [B, C, n]."""
    nb, C = targets.shape[:2]
    ws = [w.detach().requires_grad_(True) for w in weights]
    bs = [b.detach().requires_grad_(True) for b in biases]
    with torch.enable_grad():
        m, k = ws[0].shape[-2:]
        # the C chains' layer-0 weights side by side: one matmul per branch
        w0 = ws[0].permute(0, 2, 1, 3).reshape(nb, m, C * k)
        z = (xT @ w0).reshape(nb, -1, C, k).permute(0, 2, 1, 3) + bs[0][:, :, None, :]
        a = _act_apply(act, z)
        for l in range(1, len(ws) - 1):
            a = _act_apply(act, a @ ws[l] + bs[l][:, :, None, :])
        pred = (a @ ws[-1])[..., 0]
        half_rss = 0.5 * torch.sum((pred - targets) ** 2)
        grads = torch.autograd.grad(half_rss, ws + bs)
    return grads[: len(ws)], grads[len(ws):]


def integrate_chains_packed_ref(
    act, bytes_g, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b, L_steps, n, l1=False,
):
    """Plain PyTorch version of K5: decode and standardize once, then L
    leapfrog steps with autograd gradients. Returns (w_L, b_L, pw_L, pb_L)."""
    dec = unpack_strided(bytes_g, n)  # [B, m, n]
    xT = (dec * w_scale[..., None] - (shift * w_scale)[..., None]).transpose(-1, -2)
    e4, e3 = err[:, :, None, None], err[:, :, None]

    def ld_grad(ws, bs):
        dws, dbs = _data_grad(act, xT, targets, ws, bs)
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


def _flat(ws, bs) -> torch.Tensor:
    """Per-layer [B, C, ...] tensors -> [B, C, P] in the kernel's layout:
    W0, b0, (W1, b1), w_out."""
    nb, C = ws[0].shape[:2]
    parts = []
    for w, b in zip(ws[:-1], bs):
        parts += [w.reshape(nb, C, -1), b.reshape(nb, C, -1)]
    parts.append(ws[-1].reshape(nb, C, -1))
    return torch.cat(parts, dim=-1).to(torch.float32).contiguous()


def _unflat(flat, like_w, like_b):
    ws, bs, ix = [], [], 0
    for w, b in zip(like_w[:-1], like_b):
        size = w[0, 0].numel()
        ws.append(flat[..., ix : ix + size].reshape(w.shape))
        ix += size
        bs.append(flat[..., ix : ix + b.shape[-1]].reshape(b.shape))
        ix += b.shape[-1]
    ws.append(flat[..., ix:].reshape(like_w[-1].shape))
    return tuple(ws), tuple(bs)


def _integrate_cuda(
    act, bytes_g, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b, L_steps, n, l1,
):
    """Launch csrc/traj_packed.cu once for the whole block and trajectory."""
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
    w, pw = _flat(weights, biases), _flat(p_w, p_b)
    eps, lam = _flat(eps_w, eps_b), _flat(lam_w, lam_b)
    P = w.shape[-1]
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
        vp(partial.data_ptr()), nb, C, m, B, n, k0, s, P, depth, int(L_steps),
        ACT_CODES[act], int(bool(l1)), vp(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "traj_packed_f32")
    integrate_chains_packed.launches += 1
    w_f, b_f = _unflat(w, weights, biases)
    pw_f, pb_f = _unflat(pw, weights, biases)
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
    fn = integrate_chains_packed_ref if bytes_g.device.type == "cpu" else _integrate_cuda
    return fn(act_name, bytes_g, w_scale, shift, targets, err, weights, biases,
              p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps, n, l1)


integrate_chains_packed.launches = 0  # kernel launches since the last reset
