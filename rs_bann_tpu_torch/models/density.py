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
``gradients`` subcommand and gradient descent take, ``joint_potential_fn``
the joint one (parameters and precisions) of joint HMC and joint gradient
descent, on C chains of a packed block through ``predict_chains``
(``predict_joint``).

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
from ..ops.branch_mlp import forward_blocked, forward_chains
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
    (f32, or bf16 under ``--x-bf16``: the standardized f32 values rounded
    once to nearest even): the layout of the dense flagship, whose kernels
    (K6, K7, K8) read a tile of individuals for all markers at once, in
    either dtype. ``gram`` as PackedX's."""

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
    package's X_J of its marker scan (a bf16 FeatX's values, exact in
    f32)."""
    if isinstance(x, FeatX):
        return x.xT[s:e].float()
    raw = unpack_strided(x.bytes[s:e], x.n)
    return (raw - x.shift[s:e, :, None]) * x.w_scale[s:e, :, None]


def marker_gram(x) -> torch.Tensor:
    """The branch Grams X_g X_g^T [G, m_pad, m_pad] (f32) of the markers'
    standardized genotypes of ``x`` (all G branches of a PackedX or FeatX),
    for the per-marker spike-and-slab scan, by decode and a matmul in
    chunks of branches: data, so formed once per training run
    (``x.form_gram()``). The diagonal is each marker's x_j^T x_j, as the JAX
    package's ``gram[t, t]``. Made exactly symmetric (the upper triangle
    mirrored), since the scan reads a marker's row of it as its column.
    On a bf16 FeatX the JAX package's ``X_J @ X_J.T`` is a bf16 product
    whose result stays bf16: each f32 sum is rounded once to bf16 here, as
    the JAX package rounds it on the CPU (kept in f32)."""
    G, m = x.w_scale.shape if isinstance(x, PackedX) else x.xT.shape[:2]
    chunk = max(1, int(2.5e8 // (m * x.n)))
    parts = []
    for s in range(0, G, chunk):
        rows = _standardized_rows(x, s, min(G, s + chunk))
        parts.append(rows @ rows.transpose(-1, -2))
    g = torch.cat(parts)
    if isinstance(x, FeatX) and x.xT.dtype == torch.bfloat16:
        g = _bf16(g)
    return torch.triu(g) + torch.triu(g, 1).transpose(-1, -2)


def marker_u0(x, e) -> torch.Tensor:
    """u0 = X_b^T e of the scan: a block's (or one branch's) standardized
    genotypes against residuals e [n, k], [..., m_pad, k]. On a PackedX one
    K9b launch (``packed_matmul_vjp``) on the raw genotypes, then the
    standardization, w_scale * (raw - shift * sum_n e); on a FeatX one
    matmul (in f32 on a bf16 FeatX, whose values it takes exactly, as the
    JAX package's bf16 @ f32 promotes)."""
    if isinstance(x, FeatX):
        return x.xT.to(e.dtype) @ e
    raw = packed_matmul_vjp(x.bytes, e.expand(x.bytes.shape[:-2] + e.shape), x.n)
    return x.w_scale[..., None] * (raw - x.shift[..., None] * torch.sum(e, dim=0))


# Optional bf16 inputs of the plain products, accumulated in f32 (``--bf16``;
# the JAX package's ``set_compute_dtype``): None keeps every product's
# inputs as they are. It reaches ``matmul`` and ``matmul_fm`` alone: the
# kernels compute as they do without it.
_COMPUTE_DTYPE = None


def set_compute_dtype(dtype) -> None:
    """Set the plain products' input dtype: None (as given) or "bfloat16"."""
    global _COMPUTE_DTYPE
    if dtype not in (None, "bfloat16"):
        raise ValueError(f"compute dtype must be None or 'bfloat16', not {dtype!r}")
    _COMPUTE_DTYPE = dtype


def compute_dtype():
    """The plain products' input dtype set by ``set_compute_dtype``."""
    return _COMPUTE_DTYPE


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even) and held in f32, where every
    product of two such values is exact: a bf16 x bf16 ``@`` in torch would
    return bf16, and the card's library may reduce it in lower precision."""
    return t.to(torch.bfloat16).float()


def _bf16_pair(a, b):
    """The one dtype mismatch a product takes, bf16-stored X against f32
    weights: both rounded to bf16 (the JAX package's ``_bf16_pair``); any
    other mismatch is a caller's error."""
    if torch.bfloat16 not in (a.dtype, b.dtype) or not (
            a.is_floating_point() and b.is_floating_point()):
        raise TypeError(f"matmul dtype mismatch {a.dtype} vs {b.dtype}: only the "
                        "bf16-stored-X vs f32-weights pair is supported")
    return _bf16(a), _bf16(b)


def _inputs(a, b):
    if _COMPUTE_DTYPE is not None:
        return _bf16(a), _bf16(b)
    if a.dtype != b.dtype:
        return _bf16_pair(a, b)
    return a, b


def matmul(a, b) -> torch.Tensor:
    """a @ b with optional bf16 inputs and f32 accumulation (the JAX
    package's ``matmul``: TF32 stays off, so rounded inputs multiply
    exactly)."""
    a, b = _inputs(a, b)
    return a @ b


def matmul_fm(w, a) -> torch.Tensor:
    """Feature-major layer: [..., out, n] = w[..., in, out]^T @ a[..., in, n],
    inputs as ``matmul``'s."""
    wt, a = _inputs(w.transpose(-1, -2), a)
    return wt @ a


def same_operator(x) -> bool:
    """Whether ``predict`` on x is the operator of the folded transition's
    value passes (``predict_chains``): always on packed genotypes, and on an
    f32 FeatX without ``--bf16``. On a bf16 FeatX ``predict`` rounds W0 to
    bf16 (``matmul_fm``), and under ``--bf16`` every product's inputs, while
    the kernels do neither, so a sweep's snapshot predictions come from
    ``snapshot_chains`` (or, unfolded, K8's forward on ``predict_weights``)
    and the transition makes its own initial value pass."""
    return not isinstance(x, FeatX) or (x.xT.dtype == torch.float32 and _COMPUTE_DTYPE is None)


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
    XLA) and the width-1 output is a sum over the summary rows. Every plain
    product goes through ``matmul`` or ``matmul_fm`` (bf16 inputs under
    ``--bf16``; on a bf16 FeatX, W0 rounded to bf16), as in the JAX package.
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
            z = matmul(x, weights[0]) + biases[0].unsqueeze(-2)
        pre.append(z)
        a = _A.apply(canon, z)
    acts.append(a)
    for l in range(1, len(weights) - 1):
        z = matmul(a, weights[l]) + biases[l].unsqueeze(-2)
        pre.append(z)
        a = _A.apply(canon, z)
        acts.append(a)
    acts.append(matmul(a, weights[-1]))
    return pre, acts


def predict(act_name: str, weights, biases, x) -> torch.Tensor:
    """Branch prediction [..., n] (output column squeezed)."""
    return forward(act_name, weights, biases, x)[1][-1][..., 0]


def effect_sizes(act_name: str, weights, biases, x) -> torch.Tensor:
    """d y_hat / d x on the standardized genotype scale, per individual:
    [..., n, m_pad], with leading branch axes as ``forward``. The JAX
    package's ``effect_sizes`` (density.py:607-640).

    Dense sample-major x: autograd of the summed outputs with respect to x
    (each individual's output depends on its own row only). A FeatX is
    densified first. Packed x: the backward chain written out over the
    forward's activations (K2's, or K9a's under silu), with no gradient
    through the 2-bit decode: h' is rebuilt from the output on K2's fused
    layer 0 and taken from the pre-activation elsewhere."""
    if isinstance(x, FeatX):
        x = x.xT.transpose(-1, -2)
    if not isinstance(x, PackedX):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            out = torch.sum(predict(act_name, tuple(w.detach() for w in weights),
                                    tuple(b.detach() for b in biases), xx))
            return torch.autograd.grad(out, xx)[0]
    canon = _A.canonical(act_name)
    pre, acts = forward(act_name, weights, biases, x)
    # d y_hat / d (the summary activations) = w_out on every row
    w_out = weights[-1][..., 0].unsqueeze(-2)
    err = w_out.expand(acts[-1].shape[:-1] + w_out.shape[-1:])
    for l in range(len(weights) - 2, -1, -1):
        hp = (_A.prime_from_out(canon, acts[l]) if pre[l] is None
              else _A.prime(canon, pre[l], acts[l]))
        err = (hp * err) @ weights[l].transpose(-1, -2)
    return err


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
        a = _A.apply(canon, matmul(a, weights[l]) + biases[l].unsqueeze(-2))
    return matmul(a, weights[-1])[..., 0]


def predict_weights(weights, x):
    """The weights as ``predict``'s operator multiplies them on x without
    ``--bf16``: W0 rounded to bf16 on a bf16 FeatX (``matmul_fm``), else as
    they are. A kernel given them computes that operator (it multiplies
    the rounded values exactly)."""
    if isinstance(x, FeatX) and x.xT.dtype == torch.bfloat16:
        return (_bf16(weights[0]),) + tuple(weights[1:])
    return tuple(weights)


def snapshot_chains(act_name: str, weights, biases, x, k_live=None, ix=None) -> torch.Tensor:
    """A sweep's snapshot predictions [C, B, n] of C chains' weights (per
    layer [C, B, ...]) on one block: ``predict``'s operator, as the JAX
    package takes them (``D.predict`` under a vmap). ``x`` is the block's
    genotypes, or with ``ix`` (int32 [C * B], chain-major: the unfolded
    sweep) the whole FeatX, each (chain, branch) reading its branch of it
    in place. The kernel is ``predict_chains`` (K8's forward,
    ``forward_blocked``, with ``ix``), on the weights as they are where the
    two operators agree (``same_operator``) and on ``predict_weights`` on a
    bf16 FeatX (W0 rounded to bf16: ``predict`` rounds nothing else there);
    under ``--bf16`` on a FeatX it is ``predict``'s plain products (with
    ``ix`` on a copy of the instances' branches)."""
    if ix is None and same_operator(x):
        return predict_chains(act_name, weights, biases, x, k_live)
    C, B = weights[0].shape[:2]

    def flat(ts):  # [C, B, ...] -> [C * B, ...]
        return tuple(t.reshape((C * B,) + t.shape[2:]) for t in ts)

    if _COMPUTE_DTYPE is not None:
        if ix is None:
            return predict(act_name, weights, biases, x)
        return predict(act_name, flat(weights), flat(biases),
                       FeatX(x.xT[ix.long()])).reshape(C, B, -1)
    if ix is None:
        return predict_chains(act_name, predict_weights(weights, x), biases, x)
    return forward_blocked(_A.canonical(act_name), x.xT, ix, flat(predict_weights(weights, x)),
                           flat(biases)).reshape(C, B, -1)


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
            # a padded row's precision enters by where, not by multiply: its
            # log's gradient rm / lam would be NaN at lam = 0
            log_lam = torch.log(torch.where(rm > 0, lam, 1.0))
            if is_lasso(model_type):
                row_l1 = torch.sum(_abs0(w), dim=-1, keepdim=True)
                ld = ld - torch.sum(rm * (row_l1 + 1.0 / scale) * lam, dim=dims)
                ld = ld + (shape + ncols - 1.0) * torch.sum(rm * log_lam, dim=dims)
            else:
                row_ssq = torch.sum(w * w, dim=-1, keepdim=True)
                ld = ld - torch.sum(rm * (row_ssq / 2.0 + 1.0 / scale) * lam, dim=dims)
                ld = ld + (shape + (ncols - 2.0) / 2.0) * torch.sum(rm * log_lam, dim=dims)
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


def log_density_joint(model_type, weights, biases, w_precisions, b_precisions, error_precision,
                      rss, hyper, statics_g, reg_sum_others, n_out_global, num_individuals):
    """The full joint -U over the parameters AND the precisions, one value
    per leading index (the JAX package's ``log_density_joint``)."""
    return (
        _joint_local_weights(model_type, weights, w_precisions, hyper, statics_g)
        + _joint_output_weights(
            model_type, weights, w_precisions, hyper, reg_sum_others, n_out_global)
        + _joint_biases(biases, b_precisions, hyper, statics_g)
        + joint_rss_term(error_precision, rss, hyper, num_individuals)
    )


def predict_joint(act_name: str, weights, biases, x, k_live=None) -> torch.Tensor:
    """Predictions [..., n] of weights with leading axes on x, differentiable
    in the weights: C chains' [C, B, ...] weights on a packed block of B
    branches through ``predict_chains`` (the chains side by side in one K2
    or K9a launch, K3 or K9b behind it; ``k_live`` as there), else
    ``predict`` (one branch, a [B] block, or on a FeatX plain products that
    broadcast over the chains)."""
    if isinstance(x, PackedX) and weights[0].dim() == x.bytes.dim() + 1:
        return predict_chains(act_name, weights, biases, x, k_live)
    return predict(act_name, weights, biases, x)


def joint_potential_fn(model_type: str, act_name: str, k_live=None):
    """The joint HMC potential, differentiable in the parameters AND the
    precisions (the JAX package's ``joint_potential_fn``):

      f(weights, biases, w_prec, b_prec, err_prec, x, y, hyper, statics_g,
        reg_sum_others, n_out_global, residual=False) -> (-U, y_pred)

    one value and one prediction [..., n] per leading index
    (``predict_joint``); the branches' potentials are separable, so
    autograd of their sum gives every instance its own gradient. With
    ``residual`` ``y`` is the residual and the target is y + y_pred, the
    prediction taken as a constant (the caller's snapshot)."""

    def f(weights, biases, w_precisions, b_precisions, error_precision, x, y, hyper, statics_g,
          reg_sum_others, n_out_global, residual=False):
        y_pred = predict_joint(act_name, weights, biases, x, k_live)
        r = y_pred - (y + y_pred.detach() if residual else y)
        ld = log_density_joint(model_type, weights, biases, w_precisions, b_precisions,
                               error_precision, torch.sum(r * r, dim=-1), hyper, statics_g,
                               reg_sum_others, n_out_global, float(y.shape[-1]))
        return ld, y_pred

    return f
