"""Branch forward pass and log densities for all prior families.

Counterpart of rs_bann_tpu/models/density.py. Every function works on one
branch slice (per-layer tensors without the leading G axis) or on a batch
of them: the densities reduce over each layer's own axes only, so leading
(chain, branch) axes give one value per branch. ``forward`` and ``predict``
take a leading branch axis on packed, dense and feature-major input alike,
because PyTorch's matmul broadcasts over it; ``predict_chains`` evaluates C
chains' weights on one block of branches in one kernel launch (K2, or K9a
under silu, on packed genotypes; K7's forward on feature-major ones).
Autograd goes through the packed layer 0 (K3 behind K2, K9b behind K9a):
``potential_fn`` is the marginal potential whose gradient the
``gradients`` subcommand and gradient descent take.

Prior families ("model types"):
  ridge_base   one Gamma-precision per layer, Normal weights
  ridge_ard    one precision per input row in all but the output layer
  lasso_base   one precision per layer, Laplace weights
  lasso_ard    per-row Laplace rates
  std_normal   fixed unit precisions (no Gibbs)

The output layer is always base-style, with one precision shared across all
branches. Lasso L1 terms are written ``w * sign(w)`` (``_abs0``) so their
gradient is sign(w) with sign(0) = 0: a padded or exactly-zero weight feels
no prior force. ``prior_grad`` is that gradient written out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops import activations as _A
from ..ops.branch_mlp import forward_chains
from ..ops.packed_matmul import (
    FUSED_ACTIVATIONS,
    packed_linear,
    packed_matmul,
    packed_matmul_vjp,
    unpack_strided,
)
from . import NetArch
from . import params as P

MODEL_TYPES = ("ridge_base", "ridge_ard", "lasso_base", "lasso_ard", "std_normal")


def is_ard(model_type: str) -> bool:
    return model_type.endswith("_ard")


def is_lasso(model_type: str) -> bool:
    return model_type.startswith("lasso")


def _abs0(w: torch.Tensor) -> torch.Tensor:
    """|w| whose autograd gradient is sign(w), 0 at 0."""
    return w * torch.sign(w)


def summary_stat(model_type: str, w: torch.Tensor) -> torch.Tensor:
    """Sum of squares (ridge, std_normal) or of abs (lasso) of the output
    weights w [..., s, 1] of each branch, one value per leading index."""
    if is_lasso(model_type):
        return torch.sum(torch.abs(w), dim=(-2, -1))
    return torch.sum(w * w, dim=(-2, -1))


class Hyperparameters(NamedTuple):
    """Gamma (shape, scale) precision prior hyperparameters per layer group:
    dense layers, the summary layer (index L-2), the output layer (L-1)."""

    dense_shape: float = 0.001
    dense_scale: float = 1000.0
    summary_shape: float = 0.001
    summary_scale: float = 1000.0
    output_shape: float = 0.001
    output_scale: float = 1000.0

    def layer(self, l: int, num_layers: int) -> Tuple[float, float]:
        if l == num_layers - 1:
            return self.output_shape, self.output_scale
        if l == num_layers - 2:
            return self.summary_shape, self.summary_scale
        return self.dense_shape, self.dense_scale


class BranchStatics(NamedTuple):
    """Per-branch true counts and masks, stacked [G, ...] on the device."""

    w_counts: Tuple[torch.Tensor, ...]  # [G] true weights per layer
    b_counts: Tuple[torch.Tensor, ...]  # [G] true biases per layer
    row_masks: Tuple[torch.Tensor, ...]  # [G, in_pad, 1] true input-row masks
    out_counts: Tuple[torch.Tensor, ...]  # [G] true output width per layer
    n_params: torch.Tensor  # [G] true params per branch


def branch_statics(arch: NetArch, device) -> BranchStatics:
    ins = arch.layer_in_counts()
    row_masks = []
    for l in range(arch.num_layers):
        rm = np.arange(arch.layer_in_pad(l))[None, :] < np.asarray(ins[l])[:, None]
        row_masks.append(rm.astype(np.float32)[:, :, None])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return BranchStatics(
        w_counts=tuple(t(c) for c in P.weight_counts(arch)),
        b_counts=tuple(t(c) for c in P.bias_counts(arch)),
        row_masks=tuple(t(r) for r in row_masks),
        out_counts=tuple(t(c) for c in arch.layer_out_counts()),
        n_params=t(P.param_counts(arch)),
    )


def slice_branch(tree, g):
    """Branch g of a NamedTuple of tuples of stacked tensors."""
    return type(tree)(
        *(tuple(a[g] for a in f) if isinstance(f, tuple) else f[g] for f in tree)
    )


# ------------------------------------------------------------------ forward


class PackedX:
    """2-bit packed branch genotypes held on the device.

    ``bytes``   uint8 [..., m_pad, B] in the group-strided layout
    ``w_scale`` [..., m_pad] = 1/sigma per marker (0 for padded or
                zero-variance markers)
    ``shift``   [..., m_pad] = mu per marker (raw column means)
    ``n``       number of individuals
    ``gram``    the branch Grams [G, m_pad, m_pad] of the per-marker
                spike-and-slab scan, None until ``form_gram`` forms them

    Standardization folds into layer 0:
      X_std @ W = decode(bytes) @ (w_scale * W) - mu @ (w_scale * W)
    """

    def __init__(self, bytes_, w_scale, shift, n: int):
        self.bytes = bytes_
        self.w_scale = w_scale
        self.shift = shift
        self.n = int(n)
        self.gram = None

    def __getitem__(self, g):
        return PackedX(self.bytes[g], self.w_scale[g], self.shift[g], self.n)

    def form_gram(self) -> torch.Tensor:
        """Form and keep ``gram`` (``marker_gram``), once per training run."""
        self.gram = marker_gram(self)
        return self.gram


class FeatX:
    """Feature-major dense standardized branch genotypes ``xT`` [..., m_pad, n]
    (f32): the layout of the dense flagship, whose kernels (K6, K7) read a
    tile of individuals for all markers at once. ``gram`` as PackedX's."""

    def __init__(self, xT):
        self.xT = xT
        self.gram = None

    def __getitem__(self, g):
        return FeatX(self.xT[g])

    def form_gram(self) -> torch.Tensor:
        """Form and keep ``gram`` (``marker_gram``), once per training run."""
        self.gram = marker_gram(self)
        return self.gram

    @property
    def n(self) -> int:
        return self.xT.shape[-1]


def _standardized_rows(x, s: int, e: int) -> torch.Tensor:
    """Branches s..e of a PackedX or FeatX as standardized rows [e - s,
    m_pad, n] f32: (decode - shift) * w_scale on packed genotypes, the JAX
    package's X_J of its marker scan."""
    if isinstance(x, FeatX):
        return x.xT[s:e]
    raw = unpack_strided(x.bytes[s:e], x.n)
    return (raw - x.shift[s:e, :, None]) * x.w_scale[s:e, :, None]


def marker_gram(x) -> torch.Tensor:
    """The branch Grams X_g X_g^T [G, m_pad, m_pad] (f32) of the markers'
    standardized genotypes of ``x`` (all G branches of a PackedX or FeatX),
    for the per-marker spike-and-slab scan, by decode and a matmul in
    chunks of branches: data, so formed once per training run
    (``x.form_gram()``). The diagonal is each marker's x_j^T x_j, as the JAX
    package's ``gram[t, t]``. Made exactly symmetric (the upper triangle
    mirrored), since the scan reads a marker's row of it as its column."""
    G, m = x.w_scale.shape if isinstance(x, PackedX) else x.xT.shape[:2]
    chunk = max(1, int(2.5e8 // (m * x.n)))
    parts = []
    for s in range(0, G, chunk):
        rows = _standardized_rows(x, s, min(G, s + chunk))
        parts.append(rows @ rows.transpose(-1, -2))
    g = torch.cat(parts)
    return torch.triu(g) + torch.triu(g, 1).transpose(-1, -2)


def marker_u0(x, e) -> torch.Tensor:
    """u0 = X_b^T e of the scan: a block's (or one branch's) standardized
    genotypes against residuals e [n, k], [..., m_pad, k]. On a PackedX one
    K9b launch (``packed_matmul_vjp``) on the raw genotypes, then the
    standardization, w_scale * (raw - shift * sum_n e); on a FeatX one
    matmul."""
    if isinstance(x, FeatX):
        return x.xT @ e
    raw = packed_matmul_vjp(x.bytes, e.expand(x.bytes.shape[:-2] + e.shape), x.n)
    return x.w_scale[..., None] * (raw - x.shift[..., None] * torch.sum(e, dim=0))


def matmul_fm(w, a):
    """Feature-major layer: [..., out, n] = w[..., in, out]^T @ a[..., in, n]."""
    return w.transpose(-1, -2) @ a


def _layer0(weights0, bias0, x: PackedX):
    """Packed layer 0 unfused (K9a): decode(bytes)^T (w_scale * W0), then the
    standardization's shift and the bias, in the JAX package's order."""
    w0p = x.w_scale.unsqueeze(-1) * weights0
    z = packed_matmul(x.bytes, w0p, x.n) - (x.shift.unsqueeze(-2) @ w0p)
    return z + bias0.unsqueeze(-2)


def forward(act_name: str, weights, biases, x):
    """Forward pass of one branch, or of all branches when every tensor has
    a leading G axis.

    ``x`` is dense standardized sample-major [..., n, m_pad], a PackedX or a
    FeatX. Returns (pre_activations, activations) like the JAX package: one
    activation per layer, the last the output column [..., n, 1]. On packed
    input layer 0 is the fused K2 kernel and its pre-activation is None,
    except under silu, whose layer 0 is the unfused K9a product. On
    a FeatX the hidden pre-activations and activations are feature-major
    [..., width, n] (plain torch matmuls, as the JAX package leaves them to
    XLA) and the width-1 output is a sum over the summary rows.
    """
    canon = _A.canonical(act_name)
    pre, acts = [], []
    if isinstance(x, FeatX):
        a = x.xT
        for l in range(len(weights) - 1):
            z = matmul_fm(weights[l], a) + biases[l].unsqueeze(-1)
            pre.append(z)
            a = _A.apply(canon, z)
            acts.append(a)
        acts.append(torch.sum(weights[-1] * a, dim=-2).unsqueeze(-1))
        return pre, acts
    if isinstance(x, PackedX) and canon in FUSED_ACTIVATIONS:
        w0p = x.w_scale.unsqueeze(-1) * weights[0]
        off = biases[0] - (x.shift.unsqueeze(-2) @ w0p).squeeze(-2)
        a = packed_linear(x.bytes, w0p, off, x.n, canon)
        pre.append(None)
    else:
        if isinstance(x, PackedX):
            z = _layer0(weights[0], biases[0], x)
        else:
            z = x @ weights[0] + biases[0].unsqueeze(-2)
        pre.append(z)
        a = _A.apply(canon, z)
    acts.append(a)
    for l in range(1, len(weights) - 1):
        z = a @ weights[l] + biases[l].unsqueeze(-2)
        pre.append(z)
        a = _A.apply(canon, z)
        acts.append(a)
    acts.append(a @ weights[-1])
    return pre, acts


def predict(act_name: str, weights, biases, x) -> torch.Tensor:
    """Branch prediction [..., n] (output column squeezed)."""
    return forward(act_name, weights, biases, x)[1][-1][..., 0]


def chain_layer0(w0, b0, x: PackedX):
    """K2's (or K9a's) operands for C chains' layer 0 (w0 [C, B, m_pad, k0], b0
    [C, B, k0]) on one block: A [B, m_pad, C * k0] and off [B, C * k0],
    standardization folded in, chain c in columns c * k0 .. (c + 1) * k0."""
    C, B, m, k = w0.shape
    w0p = x.w_scale[None, :, :, None] * w0
    off = b0 - (x.shift[None, :, None, :] @ w0p)[..., 0, :]
    return w0p.permute(1, 2, 0, 3).reshape(B, m, C * k), off.permute(1, 0, 2).reshape(B, C * k)


def predict_chains(act_name: str, weights, biases, x, k_live=None) -> torch.Tensor:
    """Predictions [C, B, n] of C chains' weights (per layer [C, B, ...]) on
    one block's genotypes: a PackedX (bytes [B, m_pad, Bytes]) or a FeatX
    (xT [B, m_pad, n]).

    Packed: the chains' folded layer-0 weights sit side by side in K2's
    output width (``chain_layer0``), so one K2 launch serves every chain and
    the block's bytes are read once; under silu one K9a launch, then the
    offset and the activation. ``k_live`` (packed only) cuts layer 0 to its
    first k_live columns, so K2 or K9a computes and writes C * k_live
    columns: the caller passes it when every column past it has zero
    weights, bias and next-layer rows (the padded ones), which add exactly
    nothing since act(0) = 0. Feature-major: one launch of K7's
    forward-only pass (``forward_chains``), which reads each X tile once for
    all chains."""
    canon = _A.canonical(act_name)
    if isinstance(x, FeatX):
        def bc(ts):  # [C, B, ...] -> [B, C, ...]
            return tuple(t.transpose(0, 1) for t in ts)

        return forward_chains(canon, x.xT, bc(weights), bc(biases)).transpose(0, 1)
    if k_live is not None:
        weights = (weights[0][..., :k_live], weights[1][..., :k_live, :]) + tuple(weights[2:])
        biases = (biases[0][..., :k_live],) + tuple(biases[1:])
    C, B, _, k = weights[0].shape
    A, off = chain_layer0(weights[0], biases[0], x)
    if canon in FUSED_ACTIVATIONS:
        a = packed_linear(x.bytes, A, off, x.n, canon)
    else:
        a = _A.apply(canon, packed_matmul(x.bytes, A, x.n) + off.unsqueeze(-2))
    a = a.reshape(B, x.n, C, k).permute(2, 0, 1, 3)
    for l in range(1, len(weights) - 1):
        a = _A.apply(canon, a @ weights[l] + biases[l].unsqueeze(-2))
    return (a @ weights[-1])[..., 0]


def branch_rss(act_name: str, weights, biases, x, y) -> torch.Tensor:
    """Residual sum of squares of each branch (one value per leading index)."""
    r = predict(act_name, weights, biases, x) - y
    return torch.sum(r * r, dim=-1)


# --------------------------------------------------- marginal log densities


def log_density_wrt_weights(model_type: str, weights, w_precisions) -> torch.Tensor:
    """Prior term of the marginal (precision-conditional) log density."""
    ld = 0.0
    dims = (-2, -1)
    for w, lam in zip(weights, w_precisions):
        if model_type == "std_normal":
            ld = ld - 0.5 * torch.sum(w * w, dim=dims)
        elif is_lasso(model_type):
            ld = ld - torch.sum(lam * _abs0(w), dim=dims)
        else:
            ld = ld - 0.5 * torch.sum(lam * w * w, dim=dims)
    return ld


def log_density_wrt_biases(model_type: str, biases) -> torch.Tensor:
    """Biases are unregularized in the marginal density, except under
    std_normal, which gives them unit-precision terms."""
    ld = torch.zeros(biases[0].shape[:-1], dtype=biases[0].dtype, device=biases[0].device)
    if model_type == "std_normal":
        for b in biases:
            ld = ld - 0.5 * torch.sum(b * b, dim=-1)
    return ld


def prior_grad(model_type: str, weights, biases, w_precisions):
    """Gradient of log_density_wrt_weights + log_density_wrt_biases with
    respect to (weights, biases)."""
    if model_type == "std_normal":
        return tuple(-w for w in weights), tuple(-b for b in biases)
    if is_lasso(model_type):
        gw = tuple(-lam * torch.sign(w) for w, lam in zip(weights, w_precisions))
    else:
        gw = tuple(-lam * w for w, lam in zip(weights, w_precisions))
    return gw, tuple(torch.zeros_like(b) for b in biases)


def log_density(model_type, weights, biases, w_precisions, error_precision, rss):
    """-U(q) of the marginal HMC target."""
    return (
        log_density_wrt_weights(model_type, weights, w_precisions)
        + log_density_wrt_biases(model_type, biases)
        - error_precision * rss / 2.0
    )


def potential_fn(model_type: str, act_name: str):
    """f(weights, biases, w_precisions, error_precision, x, y) -> -U, one
    value per branch (leading axes). Its autograd gradient in (weights,
    biases) is the reference's analytic gradient (backprop + prior terms);
    the branches' potentials are separable, so the gradient of their sum is
    every branch's own."""

    def f(weights, biases, w_precisions, error_precision, x, y):
        rss = branch_rss(act_name, weights, biases, x, y)
        return log_density(model_type, weights, biases, w_precisions, error_precision, rss)

    return f


# ------------------------------------------------------ joint log densities


def _joint_local_weights(model_type, weights, w_precisions, hyper, statics_g):
    """Local (non-output) weight + precision terms of the joint density."""
    L = len(weights)
    ld = 0.0
    dims = (-2, -1)
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        w, lam = weights[l], w_precisions[l]
        if is_ard(model_type):
            rm = statics_g.row_masks[l]  # [..., in_pad, 1]
            ncols = statics_g.out_counts[l]
            if is_lasso(model_type):
                row_l1 = torch.sum(_abs0(w), dim=-1, keepdim=True)
                ld = ld - torch.sum(rm * (row_l1 + 1.0 / scale) * lam, dim=dims)
                ld = ld + (shape + ncols - 1.0) * torch.sum(rm * torch.log(lam), dim=dims)
            else:
                row_ssq = torch.sum(w * w, dim=-1, keepdim=True)
                ld = ld - torch.sum(rm * (row_ssq / 2.0 + 1.0 / scale) * lam, dim=dims)
                ld = ld + (shape + (ncols - 2.0) / 2.0) * torch.sum(rm * torch.log(lam), dim=dims)
        else:
            nvar = statics_g.w_counts[l]
            lam0 = lam[..., 0, 0]
            if is_lasso(model_type):
                ld = ld - (torch.sum(_abs0(w), dim=dims) + 1.0 / scale) * lam0
                ld = ld + (shape + nvar - 1.0) * torch.log(lam0)
            else:
                ld = ld - (torch.sum(w * w, dim=dims) / 2.0 + 1.0 / scale) * lam0
                ld = ld + (shape + (nvar - 2.0) / 2.0) * torch.log(lam0)
    return ld


def _joint_output_weights(
    model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global
):
    """Output weights + shared precision term; ``reg_sum_others`` is the
    summary stat of all other branches' output weights."""
    L = len(weights)
    shape, scale = hyper.layer(L - 1, L)
    lam = w_precisions[-1][..., 0, 0]
    tot = summary_stat(model_type, weights[-1]) + reg_sum_others
    if is_lasso(model_type):
        return -(tot + 1.0 / scale) * lam + (shape + n_out_global - 1.0) * torch.log(lam)
    return -(tot / 2.0 + 1.0 / scale) * lam + (
        shape + (n_out_global - 2.0) / 2.0
    ) * torch.log(lam)


def _joint_biases(biases, b_precisions, hyper, statics_g):
    """l2-regularized bias + precision terms."""
    L = len(biases) + 1
    ld = 0.0
    for l in range(L - 1):
        shape, scale = hyper.layer(l, L)
        lam = b_precisions[l][..., 0]
        nvar = statics_g.b_counts[l]
        ld = ld - lam * (torch.sum(biases[l] ** 2, dim=-1) / 2.0 + 1.0 / scale)
        ld = ld + (shape + (nvar - 2.0) / 2.0) * torch.log(lam)
    return ld


def joint_rss_term(error_precision, rss, hyper: Hyperparameters, num_individuals):
    """RSS + error precision term, with the output layer's hyperparameters
    as the error precision prior."""
    return (hyper.output_shape + (num_individuals - 2.0) / 2.0) * torch.log(
        error_precision
    ) - error_precision * (rss / 2.0 + 1.0 / hyper.output_scale)


def joint_local_term(model_type, weights, biases, w_precisions, b_precisions, hyper, statics_g):
    """Per-branch local LPD contribution."""
    return _joint_local_weights(
        model_type, weights, w_precisions, hyper, statics_g
    ) + _joint_biases(biases, b_precisions, hyper, statics_g)


def joint_output_term(model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global):
    return _joint_output_weights(
        model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global
    )
