"""The per-marker spike-and-slab scan (``cfg.ss_markers``) over a batch of
independent instances.

Counterpart of the sequential core of rs_bann_tpu/models/net.py
``_marker_ss_scan``: per instance (one chain's branch) a collapsed
conjugate Gibbs move for each layer-0 row (marker), in the instance's
visiting order, against a live residual. The JAX package runs it as jnp
inside ``lax.scan``; here it is one hand-written CUDA launch for all
instances (csrc/marker_scan.cu, which says why), with the plain PyTorch
version ``marker_scan_ref`` it is held against. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.

The scan works in coefficient space: it takes u0 = X_g^T e, the branch's
standardized genotypes against the residual at the current parameters, and
the branch Gram G_g = X_g X_g^T, and after each marker moves u by -G_g[j]
times the change of that marker's effect. That is the JAX package's
within-block recursion run over the whole branch, exact in arithmetic; the
residual itself is never formed (every JAX caller drops the scan's final
residual). It takes its random draws as tensors, so a test can feed it the
JAX package's own.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# what csrc/marker_scan.cu takes (its kMaxM, kMaxS; beyond them the launch
# raises): the Gram row of a step in 32 registers a lane (m_pad <= 1024), a
# row's columns one a lane, or two past s_pad 32 (s_pad <= 64)
MAX_M, MAX_S = 1024, 64


def marker_scan_ref(gram, gix, u0, W0, w_out, eta, lam_e, pi, row_mask, col_mask, force, order,
                    u_z, n_a, xi, probs: bool = False):
    """Plain PyTorch version of the scan, over I instances.

    gram [Gg, m, m] the branch Grams (symmetric; a step reads row j);
    gix [I] each instance's branch in ``gram``; u0 [I, m] = X_g^T e; W0
    [I, m, s] layer 0; w_out [I, s] the output column; eta [I, m, s] the
    slab precisions, already drawn and clipped; lam_e and pi [I] the error
    precision and the marker inclusion probability; row_mask [I, m] and
    col_mask [I, s] the true markers and columns; ``force`` keeps every
    true marker in (the warm-up); order [I, m] each instance's visiting
    order, a permutation; u_z and n_a [I, m] the Bernoulli uniforms and the
    normals of a_j, xi [I, m, s] the normals of the row, all indexed by
    marker. Returns (z [I, m], W0_new [I, m, s]) in W0's dtype; with
    ``probs`` also each marker's inclusion probability [I, m]."""
    I, m, s = W0.shape
    ar = torch.arange(I, device=W0.device)
    wn2 = torch.sum(w_out * w_out, dim=-1)
    wnorm = torch.sqrt(torch.clamp(wn2, min=1e-30))
    what = w_out / wnorm[:, None]
    logit_pi = torch.log(pi) - torch.log1p(-pi)
    u = u0.clone()
    W = W0.clone()
    z = torch.zeros((I, m), dtype=W0.dtype, device=W0.device)
    p_all = torch.zeros_like(z)
    for t in range(m):
        j = order[:, t]
        row = W[ar, j]
        gjj = gram[gix, j, j]
        beta_old = torch.sum(row * w_out, dim=-1)
        u_mj = u[ar, j] + gjj * beta_old
        d = col_mask / eta[ar, j]
        dw = d * what
        v_a = torch.clamp(torch.sum(what * dw, dim=-1), min=1e-30)
        lam_a = 1.0 / v_a
        q_a = lam_a + lam_e * gjj * wn2
        log_bf = 0.5 * torch.log(lam_a / q_a) + 0.5 * (lam_e * wnorm * u_mj) ** 2 / q_a
        p = torch.sigmoid(logit_pi + log_bf)
        zj = torch.ones_like(p) if force else (u_z[ar, j] < p).to(W0.dtype)
        zj = zj * row_mask[ar, j]
        a = lam_e * wnorm * u_mj / q_a + n_a[ar, j] / torch.sqrt(q_a)
        x = xi[ar, j] * torch.sqrt(d)
        x = x - dw * (torch.sum(x * what, dim=-1) / v_a)[:, None]
        new = torch.where(zj[:, None] > 0, (dw / v_a[:, None]) * a[:, None] + x, 0.0)
        db = torch.sum(new * w_out, dim=-1) - beta_old
        u = u - gram[gix, j] * db[:, None]
        W[ar, j] = new
        z[ar, j] = zj
        p_all[ar, j] = p
    return (z, W, p_all) if probs else (z, W)


def _check(t, name, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected {dtype} "
                         f"{tuple(shape)} on {dev}")


def _marker_scan_cuda(gram, gix, u0, W0, w_out, eta, lam_e, pi, row_mask, col_mask, force, order,
                      u_z, n_a, xi):
    I, m, s = W0.shape
    dev = W0.device
    f32, i64 = torch.float32, torch.int64
    ins = [(gram, "gram", f32, (gram.shape[0], m, m)), (gix, "gix", i64, (I,)),
           (u0, "u0", f32, (I, m)), (W0, "W0", f32, (I, m, s)), (w_out, "w_out", f32, (I, s)),
           (lam_e, "lam_e", f32, (I,)), (pi, "pi", f32, (I,)),
           (row_mask, "row_mask", f32, (I, m)), (col_mask, "col_mask", f32, (I, s)),
           (order, "order", i64, (I, m)), (u_z, "u_z", f32, (I, m)), (n_a, "n_a", f32, (I, m)),
           (xi, "xi", f32, (I, m, s))]
    for t, name, dtype, shape in ins + [(eta, "eta", f32, (I, m, s))]:
        _check(t, name, dtype, shape, dev)
    gram_, gix_, u0_, W0_, w_out_, lam_e_, pi_, rm_, cm_, order_, uz_, na_, xi_ = (
        t.contiguous() for t, *_ in ins)
    z = torch.empty((I, m), dtype=f32, device=dev)
    W = torch.empty((I, m, s), dtype=f32, device=dev)
    vp = ctypes.c_void_p
    status = _build.lib().marker_scan_f32(
        *(vp(t.data_ptr()) for t in (gram_, gix_, u0_, W0_, w_out_, eta)), *eta.stride(),
        *(vp(t.data_ptr()) for t in (lam_e_, pi_, rm_, cm_, order_, uz_, na_, xi_, z, W)),
        I, m, s, int(bool(force)), vp(_build.stream_ptr(W0)))
    _build.check(status, "marker_scan_f32")
    marker_scan.launches += 1
    return z, W


def marker_scan(gram, gix, u0, W0, w_out, eta, lam_e, pi, row_mask, col_mask, force, order, u_z,
                n_a, xi):
    """The scan for I instances (arguments as ``marker_scan_ref``): on a
    CPU tensor the plain version, on a CUDA tensor one launch of
    csrc/marker_scan.cu (f32, the indices int64, eta read in place at its
    strides; it raises beyond m_pad MAX_M or s_pad MAX_S). Returns (z [I, m], W0_new [I, m, s])."""
    if W0.device.type == "cpu":
        return marker_scan_ref(gram, gix, u0, W0, w_out, eta, lam_e, pi, row_mask, col_mask,
                               force, order, u_z, n_a, xi)
    return _marker_scan_cuda(gram, gix, u0, W0, w_out, eta, lam_e, pi, row_mask, col_mask, force,
                             order, u_z, n_a, xi)


marker_scan.launches = 0  # kernel launches since the last reset


def scan_ties(z, z_ref, order, u_z, p64, tol: float = 1e-5):
    """How two runs of the scan on the same inputs (the kernel and the plain
    version) may differ: an instance whose z first disagrees, in its
    visiting order, at a marker whose Bernoulli uniform lies within ``tol``
    of its inclusion probability as the plain version run in f64 puts it
    (``p64``, from ``marker_scan_ref(..., probs=True)`` on f64 inputs) is a
    near tie, decided by rounding, after which the instance's chains part.
    Returns (same [I] bool: the instances whose z agree everywhere, the
    number of near-tie instances); raises AssertionError on a disagreement
    that is no near tie."""
    diff = (z != z_ref).cpu()
    order, u_z, p64 = order.cpu(), u_z.cpu().double(), p64.cpu()
    ties = 0
    for i in torch.nonzero(diff.any(-1)).flatten().tolist():
        j = int(order[i][diff[i, order[i]]][0])
        gap = abs(float(u_z[i, j]) - float(p64[i, j]))
        if not gap < tol:
            raise AssertionError(f"instance {i}: z first differs at marker {j}, |u - p| = {gap}")
        ties += 1
    return ~diff.any(-1), ties
