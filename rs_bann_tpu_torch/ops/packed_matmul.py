"""2-bit group-strided genotypes and the packed layer 0 with its gradients.

Counterpart of rs_bann_tpu/ops/packed_matmul.py. The genotype bytes keep
the JAX package's group-strided layout (``pack_strided``): individuals come
in groups of 512; byte column j of a group holds individuals j, j+128,
j+256 and j+384 in bit pairs (0, 2, 4, 6). Code 00 -> 2, 01 -> 0 (missing,
also the padding past n), 10 -> 1, 11 -> 0.

Four hand-written CUDA kernels, each with a plain PyTorch version it is
held against and a launch counter:

* ``packed_linear``     K2, ``act(decode(bytes)[:, :n]^T @ a + off)``
  (csrc/packed_linear.cu: bf16 tensor cores with ``a`` split into three
  bf16 parts, so the f32 products stay exact), for the activations whose
  derivative the output determines (FUSED_ACTIVATIONS);
* ``packed_matmul``     K9a, ``decode(bytes)[:, :n]^T @ a``, the same
  kernel without the epilogue, for silu;
* ``packed_linear_vjp`` K3, the backward of ``packed_linear``:
  ``dz = g * h'(out)``, ``da = decode(bytes) @ dz``, ``d_off = sum_n dz``
  (csrc/packed_bwd.cu: K4's gradient on bf16 tensor cores, dz split into
  three bf16 parts, the tiles streamed by cp.async; the saved output is
  read only where h' needs it);
* ``packed_matmul_vjp`` K9b, the backward of ``packed_matmul``:
  ``da = decode(bytes) @ g``, the same kernel without h' and d_off.

``packed_linear`` and ``packed_matmul`` are differentiable in ``a`` (and
``off``), never in the bytes, as the JAX package's two ``custom_vjp``s:
autograd through them runs K3 or K9b. ``packed_linear`` keeps its output
as the residual, ``packed_matmul`` only the bytes. The port's K3 takes any
number of markers (it tiles them itself), so it needs no counterpart of
JAX's fallback to K9b for a branch wider than one marker tile: on the port
K9b serves silu alone. A CPU tensor runs the plain versions; a CUDA tensor
launches the kernel or raises. All take an optional leading branch axis G.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .activations import ACT_CODES
from .activations import apply as _act_apply
from .activations import prime_from_out as _act_prime_from_out

GROUP = 512  # individuals per strided group
GBYTES = GROUP // 4  # bytes per marker per group

# genotype value -> 2-bit code (PLINK bed encoding)
_VALUE_TO_CODE = np.array([0b11, 0b10, 0b00], np.uint8)

# Activations whose fused kernel epilogue the JAX package also fuses
# (their derivative is recoverable from the output); silu goes through K9.
FUSED_ACTIVATIONS = ("identity", "relu", "leaky_relu", "tanh")


def pack_strided(vals: np.ndarray) -> np.ndarray:
    """[m, n] genotypes {0,1,2} -> group-strided packed [m, ceil(n/512)*128].

    Within each 512-individual group, byte j carries individuals
    (j, j+128, j+256, j+384) in bit pairs (0, 2, 4, 6). Missing tail
    individuals get code 01 (decodes to 0).
    """
    m, n = vals.shape
    ngroups = -(-n // GROUP)
    codes = np.full((m, ngroups * GROUP), 0b01, np.uint8)
    codes[:, :n] = _VALUE_TO_CODE[vals.astype(np.int64)]
    codes = codes.reshape(m, ngroups, 4, GBYTES)  # [m, g, quarter, j]
    out = (
        codes[:, :, 0, :]
        | (codes[:, :, 1, :] << 2)
        | (codes[:, :, 2, :] << 4)
        | (codes[:, :, 3, :] << 6)
    )
    return np.ascontiguousarray(out.reshape(m, ngroups * GBYTES))


def strided_from_bed(cols: np.ndarray, n: int, m_pad: int) -> np.ndarray:
    """PLINK variant-major bytes [m, ceil(n/4)] (4 individuals a byte, in
    order) -> the group-strided bytes [m_pad, ceil(n/512)*128] that
    ``pack_strided`` writes for their decoded genotypes, moved as 2-bit
    codes without decoding: a missing genotype (01, decoded as 0) becomes
    11, rows past m hold genotype 0 (11) and individuals past n 01."""
    m = cols.shape[0]
    ngroups = -(-n // GROUP)
    codes = np.full((m_pad, ngroups * GROUP), 0b01, np.uint8)
    codes[m:, :n] = 0b11
    c = np.stack([(cols >> (2 * q)) & 0b11 for q in range(4)], axis=-1).reshape(m, -1)[:, :n]
    codes[:m, :n] = c | ((c & 1) << 1)
    codes = codes.reshape(m_pad, ngroups, 4, GBYTES)
    out = (
        codes[:, :, 0, :]
        | (codes[:, :, 1, :] << 2)
        | (codes[:, :, 2, :] << 4)
        | (codes[:, :, 3, :] << 6)
    )
    return np.ascontiguousarray(out.reshape(m_pad, ngroups * GBYTES))


def unpack_strided(bytes_mb: torch.Tensor, n: int) -> torch.Tensor:
    """Group-strided packed [..., m, B] -> [..., m, n] f32 genotypes."""
    *lead, m, B = bytes_mb.shape
    b = bytes_mb.reshape(*lead, m, B // GBYTES, GBYTES)
    codes = torch.cat([(b >> (2 * q)) & 0b11 for q in range(4)], dim=-1)
    # code c -> genotype (18 >> 2c) & 3: 00 -> 2, 01 -> 0, 10 -> 1, 11 -> 0
    vals = (torch.full_like(codes, 18) >> (codes + codes)) & 0b11
    return vals.to(torch.float32).reshape(*lead, m, B * 4)[..., :n]


def packed_matmul_ref(bytes_mb, a, n: int) -> torch.Tensor:
    """Plain PyTorch version of K9a: decode to f32, then matmul.
    bytes [..., m, B], a [..., m, k] -> [..., n, k]."""
    return unpack_strided(bytes_mb, n).transpose(-1, -2) @ a


def packed_linear_ref(bytes_mb, a, off, n: int, act: str) -> torch.Tensor:
    """Plain PyTorch version of K2: decode to f32, then matmul + offset +
    activation. bytes [..., m, B], a [..., m, k], off [..., k] -> [..., n, k]."""
    return _act_apply(act, packed_matmul_ref(bytes_mb, a, n) + off.unsqueeze(-2))


def packed_matmul_vjp_ref(bytes_mb, g, n: int) -> torch.Tensor:
    """Plain PyTorch version of K9b: da [..., m, k] = decode(bytes)[..., :, :n] @ g
    for the cotangent g [..., n, k]."""
    return unpack_strided(bytes_mb, n) @ g


def packed_linear_vjp_ref(bytes_mb, g, out, n: int, act: str):
    """Plain PyTorch version of K3: dz = g * h'(out) with h' rebuilt from the
    forward's output [..., n, k]; returns (da [..., m, k] = decode(bytes) @ dz,
    d_off [..., k] = sum_n dz)."""
    dz = g * _act_prime_from_out(act, out)
    return unpack_strided(bytes_mb, n) @ dz, torch.sum(dz, dim=-2)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


PLAN_FIELDS = ("nt", "passes", "slab_markers", "slabs", "tiles", "ctas", "ctas_per_sm",
               "stage_row", "weight_row", "smem")


def packed_linear_plan(G: int, m: int, B: int, k: int, n: int, fused: bool = True) -> dict:
    """What a launch of K2 (``fused``) or K9a on bytes [G, m, B] with k
    columns and n individuals uses on the current CUDA device, as the
    kernel picks it from the shape: column tiles of 8 per pass (nt), column
    passes, markers per slab and slabs, tiles of 64 byte columns per branch,
    CTAs in the grid and resident per SM, the staged output and weight row
    widths, and the shared bytes per CTA."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    _build.check(_build.lib().packed_linear_plan(int(fused), G, m, B, k, n, out),
                 "packed_linear_plan")
    return dict(zip(PLAN_FIELDS, out))


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _packed_linear_cuda(bytes_g, a, off, n: int, act: str) -> torch.Tensor:
    """Launch K2 (csrc/packed_linear.cu) on [G, m, B] bytes; returns [G, n, k]."""
    G, m, B = bytes_g.shape
    k = a.shape[-1]
    dev = bytes_g.device
    _check_packed(B, n)
    _check(bytes_g, "bytes", torch.uint8, (G, m, B), dev)
    _check_aligned(bytes_g, "bytes")
    _check(a, "a", torch.float32, (G, m, k), dev)
    _check(off, "off", torch.float32, (G, k), dev)
    out = torch.empty((G, n, k), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = _build.lib().packed_linear_f32(
        vp(bytes_g.data_ptr()), vp(a.data_ptr()), vp(off.data_ptr()),
        vp(out.data_ptr()), G, m, B, k, n, ACT_CODES[act],
        vp(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "packed_linear_f32")
    packed_linear.launches += 1
    packed_linear.widths[k] = packed_linear.widths.get(k, 0) + 1
    return out


def _packed_matmul_cuda(bytes_g, a, n: int) -> torch.Tensor:
    """Launch K9a (K2's kernel without its epilogue) on [G, m, B] bytes;
    returns [G, n, k]."""
    G, m, B = bytes_g.shape
    k = a.shape[-1]
    dev = bytes_g.device
    _check_packed(B, n)
    _check(bytes_g, "bytes", torch.uint8, (G, m, B), dev)
    _check_aligned(bytes_g, "bytes")
    _check(a, "a", torch.float32, (G, m, k), dev)
    out = torch.empty((G, n, k), dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = _build.lib().packed_matmul_f32(
        vp(bytes_g.data_ptr()), vp(a.data_ptr()), vp(out.data_ptr()), G, m, B, k, n,
        vp(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "packed_matmul_f32")
    packed_matmul.launches += 1
    packed_matmul.widths[k] = packed_matmul.widths.get(k, 0) + 1
    return out


BWD_PLAN_FIELDS = ("nt", "slab_markers", "marker_slabs", "column_slabs", "tiles", "ctas",
                   "ctas_per_sm", "row", "rows", "stage", "smem")


def packed_bwd_plan(G: int, m: int, B: int, k: int, n: int, act: str = "identity",
                    fused: bool = True) -> dict:
    """What a launch of K3 (``fused``, under ``act``) or K9b on bytes [G, m,
    B] with k columns and n individuals uses on the current CUDA device, as
    the kernel picks it from the shape: column tiles of 8 (nt), markers per
    slab, marker and column slabs, tiles of 64 byte columns per branch, CTAs
    in the grid and resident per SM, floats per partial row and partial
    rows, bytes per staged tile and shared bytes per CTA."""
    out = (ctypes.c_longlong * len(BWD_PLAN_FIELDS))()
    _build.check(_build.lib().packed_bwd_plan(int(fused), ACT_CODES[act] if fused else 0, G, m,
                                              B, k, n, out), "packed_bwd_plan")
    return dict(zip(BWD_PLAN_FIELDS, out))


def _packed_bwd_cuda(bytes_g, g, out, n: int, act: str, fused: bool):
    """Launch K3 (``fused``) or K9b (csrc/packed_bwd.cu) on [G, m, B] bytes
    and the cotangent g [G, n, k] (and K2's output ``out`` [G, n, k] for K3);
    returns (da [G, m, k], d_off [G, k] or None). The partial rows' size
    comes from the kernel's own plan."""
    G, m, B = bytes_g.shape
    k = g.shape[-1]
    dev = bytes_g.device
    _check_packed(B, n)
    _check(bytes_g, "bytes", torch.uint8, (G, m, B), dev)
    _check_aligned(bytes_g, "bytes")
    _check(g, "g", torch.float32, (G, n, k), dev)
    if fused:
        _check(out, "out", torch.float32, (G, n, k), dev)
    plan = packed_bwd_plan(G, m, B, k, n, act, fused)
    part = torch.empty(plan["rows"] * plan["row"], dtype=torch.float32, device=dev)
    da = torch.empty((G, m, k), dtype=torch.float32, device=dev)
    doff = torch.empty((G, k), dtype=torch.float32, device=dev) if fused else None

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    status = _build.lib().packed_bwd_f32(
        ptr(bytes_g), ptr(g), ptr(out if fused else None), ptr(part), part.numel(), ptr(da),
        ptr(doff), G, m, B, k, n, ACT_CODES[act] if fused else 0, int(fused),
        ctypes.c_void_p(_build.stream_ptr(bytes_g)),
    )
    _build.check(status, "packed_bwd_f32")
    return da, doff


def _check_packed(B: int, n: int) -> None:
    if B % GBYTES or n > 4 * B or n <= 0:
        raise ValueError(f"bad packed shape: B={B}, n={n}")


def _batched(fn, bytes_mb, *ts):
    """Run a [G, ...] launcher on inputs with or without the leading G axis."""
    if bytes_mb.dim() == 2:
        res = fn(bytes_mb[None], *(t[None].contiguous() for t in ts))
        return tuple(r[0] if r is not None else None for r in res) if isinstance(res, tuple) \
            else res[0]
    return fn(bytes_mb, *(t.contiguous() for t in ts))


def packed_linear_vjp(bytes_mb, g, out, n: int, act: str):
    """K3: (da [..., m, k], d_off [..., k]) for the cotangent ``g`` of
    ``packed_linear``'s output ``out`` [..., n, k]. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (and raises if it
    cannot)."""
    if act not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation not fusable: {act}")
    if bytes_mb.device.type == "cpu":
        return packed_linear_vjp_ref(bytes_mb, g, out, n, act)
    res = _batched(lambda b, g_, o_: _packed_bwd_cuda(b, g_, o_, n, act, True), bytes_mb, g, out)
    packed_linear_vjp.launches += 1
    return res


def packed_matmul_vjp(bytes_mb, g, n: int) -> torch.Tensor:
    """K9b: da [..., m, k] = decode(bytes)[..., :, :n] @ g for the cotangent
    ``g`` [..., n, k] of ``packed_matmul``. A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (and raises if it cannot)."""
    if bytes_mb.device.type == "cpu":
        return packed_matmul_vjp_ref(bytes_mb, g, n)
    da = _batched(lambda b, g_: _packed_bwd_cuda(b, g_, None, n, "identity", False)[0],
                  bytes_mb, g)
    packed_matmul_vjp.launches += 1
    return da


class _PackedLinear(torch.autograd.Function):
    """K2 forward, K3 backward; the residual is the output (``_pl_fwd``)."""

    @staticmethod
    def forward(ctx, bytes_mb, a, off, n, act):
        if bytes_mb.device.type == "cpu":
            out = packed_linear_ref(bytes_mb, a, off, n, act)
        else:
            out = _batched(lambda b, a_, o_: _packed_linear_cuda(b, a_, o_, n, act),
                           bytes_mb, a, off)
        ctx.save_for_backward(bytes_mb, out)
        ctx.n, ctx.act = n, act
        return out

    @staticmethod
    def backward(ctx, g):
        bytes_mb, out = ctx.saved_tensors
        da, d_off = packed_linear_vjp(bytes_mb, g.contiguous(), out, ctx.n, ctx.act)
        return None, da, d_off, None, None


class _PackedMatmul(torch.autograd.Function):
    """K9a forward, K9b backward; the residual is the bytes alone (``_fwd``)."""

    @staticmethod
    def forward(ctx, bytes_mb, a, n):
        if bytes_mb.device.type == "cpu":
            z = packed_matmul_ref(bytes_mb, a, n)
        else:
            z = _batched(lambda b, a_: _packed_matmul_cuda(b, a_, n), bytes_mb, a)
        ctx.save_for_backward(bytes_mb)
        ctx.n = n
        return z

    @staticmethod
    def backward(ctx, g):
        (bytes_mb,) = ctx.saved_tensors
        return None, packed_matmul_vjp(bytes_mb, g.contiguous(), ctx.n), None


def packed_linear(bytes_mb, a, off, n: int, act: str) -> torch.Tensor:
    """out[..., n, k] = act(decode(bytes_mb)[..., :, :n]^T @ a + off) (K2).

    ``bytes_mb`` [m, B] or [G, m, B] uint8 in the group-strided layout;
    ``a`` [..., m, k] = w_scale * W0 and ``off`` [..., k] = b0 - shift @ a
    fold the standardization in (models/density.py). ``act`` must be one of
    FUSED_ACTIVATIONS. Differentiable in ``a`` and ``off`` (backward K3).
    """
    if act not in FUSED_ACTIVATIONS:
        raise ValueError(f"activation not fusable: {act}")
    return _PackedLinear.apply(bytes_mb, a, off, n, act)


def packed_matmul(bytes_mb, a, n: int) -> torch.Tensor:
    """Z[..., n, k] = decode(bytes_mb)[..., :, :n]^T @ a (K9a), the unfused
    layer-0 product. Differentiable in ``a`` (backward K9b)."""
    return _PackedMatmul.apply(bytes_mb, a, n)


# kernel launches since the last reset; K2's and K9a's also by output
# width k (launches per k)
packed_linear.launches = 0
packed_matmul.launches = 0
packed_linear.widths = {}
packed_matmul.widths = {}
packed_linear_vjp.launches = 0
packed_matmul_vjp.launches = 0
