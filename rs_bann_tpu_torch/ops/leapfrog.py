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
``integrate_chains_ref``). K5 takes any depth and padded widths up to 64:
at depth 0 and widths up to 32 it decodes each genotype of a staged byte
tile once for a chunk of CC chains; at every other shape it runs the
design it shares with K4 (csrc/packed_deep.cuh), a staged tile of 64
individuals for a chunk of CC chains whose weights fit shared memory
together (``traj_packed_plan`` says which design, CC and grid a launch
uses); the packed standardization is folded into the weights inside the
kernel, so its f32 sums are rounded in another order than the plain
version's. K6 runs its gradients on tf32 tensor cores in 3xTF32 (three
tf32 products per f32 one), a branch's C chains in chunks of CC on each
staged tile of X (``traj_dense_plan`` says which CC and grid a launch
uses), and reads its per-layer inputs in place, broadcast step sizes and
prior factors included; its sums are rounded in another order too. K6
takes any depth and padded widths up to 64: past depth 1 or width 32 it
runs the dense deep design (csrc/dense_deep.cuh: one chain a CTA over
tiles of 64 individuals, layer 0 in 3xTF32, the hidden layers on the f32
cores) on flat copies of its per-layer inputs. K6 reads X stored in f32
or in bf16 (``--x-bf16``: its entries' ``x_bf16`` argument, a bf16 X tile; the
products as on the f32 values it upcasts to exactly), as K7 and K8 do
(ops/branch_mlp.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .activations import ACT_CODES
from .branch_mlp import (
    SUPPORTED_ACTIVATIONS,
    _check_x,
    _dense_shape,
    _pick_km,
    _scratch,
    data_vg_chains_ref,
    dense_deep,
    flat_params,
    layer_shapes,
    layer_slots,
    pass_instances,
    traj_dense_smem,
    traj_packed_smem,
    unflat_params,
    x_bf16,
)
from .packed_matmul import GBYTES, _check, _check_aligned, unpack_strided


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


K5_PLAN_FIELDS = ("km", "cc", "ctas_per_sm", "smem", "ctas", "scratch", "slots")


@functools.lru_cache(maxsize=None)
def _k5_plan(device_index: int, m: int, k0: int, s: int, k_live: int, depth: int, nb: int, C: int,
             B: int, n: int) -> tuple:
    out = (ctypes.c_longlong * len(K5_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().traj_packed_plan(m, k0, s, k_live, depth, nb, C, B, n, out),
                     "traj_packed_plan")
    return tuple(out)


def traj_packed_plan(m: int, k0: int, s: int, k_live: int, depth: int, nb: int, C: int, B: int,
                     n: int, device=None) -> dict:
    """What a K5 launch for nb branches of bytes [m, B], n individuals,
    padded widths k0 and s, live width k_live and C chains uses on a CUDA
    device (the current one by default): the register width KM (the deep
    design's width class past depth 0 or width 32), chains per chunk CC,
    resident blocks per SM, shared bytes per block, blocks in the
    cooperative grid, floats of partial scratch and the deep design's
    segments per block (0 at depth 0)."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(K5_PLAN_FIELDS, _k5_plan(index, m, k0, s, k_live, depth, nb, C, B, n)))


def _integrate_packed_cuda(
    act, bytes_g, w_scale, shift, targets, err, weights, biases, p_w, p_b,
    eps_w, eps_b, lam_w, lam_b, L_steps, n, l1,
):
    """Launch csrc/traj_packed.cu once for the whole block and trajectory.
    At depth 0 and widths up to 32 the kernel computes only the block's live
    columns (``live_width``), the others it leaves as they are; any other
    shape runs the deep design on every column. Either serves the C chains
    in chunks of CC from each staged byte tile (``traj_packed_plan``). A
    shape that passes ``traj_packed_smem`` always fits at CC = 1; anything
    else raises."""
    nb, m, B = bytes_g.shape
    C = targets.shape[1]
    depth = len(weights) - 2
    k0 = weights[0].shape[-1]
    s = weights[-1].shape[-2]
    dev = bytes_g.device
    if B % GBYTES or n > 4 * B or n <= 0:
        raise ValueError(f"bad packed shape: B={B}, n={n}")
    if traj_packed_smem(m, k0, s, depth) < 0:
        raise NotImplementedError(
            f"the K5 CUDA kernel takes padded layer widths up to 64 within 227 KB of shared "
            f"memory; got depth={depth}, m={m}, k0={k0}, s={s}"
        )
    w, pw = flat_params(weights, biases), flat_params(p_w, p_b)
    eps, lam = flat_params(eps_w, eps_b), flat_params(lam_w, lam_b)
    P = w.shape[-1]
    depth0 = depth == 0 and _pick_km(k0, s) > 0
    k_live = live_width(k0, w, pw, eps, lam) if depth0 else k0
    scale, shift = w_scale.contiguous(), shift.contiguous()
    targets, err = targets.contiguous(), err.contiguous()
    _check(bytes_g, "bytes", torch.uint8, (nb, m, B), dev)
    _check_aligned(bytes_g, "bytes")
    _check(scale, "w_scale", torch.float32, (nb, m), dev)
    _check(shift, "shift", torch.float32, (nb, m), dev)
    _check(targets, "targets", torch.float32, (nb, C, n), dev)
    _check(err, "err", torch.float32, (nb, C), dev)
    for name, t in (("weights", w), ("momenta", pw), ("eps", eps), ("lam", lam)):
        _check(t, name, torch.float32, (nb, C, P), dev)
    scratch = _k5_plan(dev.index, m, k0, s, k_live, depth, nb, C, B, n)[5]
    partial = torch.empty(scratch, dtype=torch.float32, device=dev)
    vp = ctypes.c_void_p
    status = _build.lib().traj_packed_f32(
        vp(bytes_g.data_ptr()), vp(scale.data_ptr()), vp(shift.data_ptr()),
        vp(targets.data_ptr()), vp(err.data_ptr()), vp(eps.data_ptr()),
        vp(lam.data_ptr()), vp(w.data_ptr()), vp(pw.data_ptr()),
        vp(partial.data_ptr()), scratch, nb, C, m, B, n, k0, k_live, s, P, depth, int(L_steps),
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
    forward; bf16 xT upcast exactly). Returns (w_L, b_L, pw_L, pb_L)."""
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


K6_PLAN_FIELDS = ("ctas", "ctas_per_sm", "cc", "chunks", "tiles", "smem", "buffers", "scratch",
                  "km")


@functools.lru_cache(maxsize=None)
def _k6_plan(device_index: int, G: int, C: int, m: int, n: int, k0: int, s: int, depth: int,
             act: int, xb: int = 0) -> tuple:
    out = (ctypes.c_longlong * len(K6_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        _build.check(_build.lib().traj_dense_plan(G, C, m, n, k0, s, depth, act, xb, out),
                     "traj_dense_plan")
    return tuple(out)


def traj_dense_plan(G: int, C: int, m: int, n: int, k0: int, s: int, depth: int,
                    act: str = "tanh", device=None, x_dtype=torch.float32) -> dict:
    """What a K6 launch for G branches of m_pad markers, C chains and n
    individuals under ``act`` on X of ``x_dtype`` uses on a CUDA device (the
    current one by default): CTAs in the cooperative grid, resident CTAs per
    SM, chains per CTA (CC), chunks of chains, tiles of 32 individuals per
    branch, shared bytes per CTA, X tile buffers, scratch bytes (the partial
    rows of one evaluation) and the register width KM."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(zip(K6_PLAN_FIELDS, _k6_plan(index, G, C, m, n, k0, s, depth, ACT_CODES[act],
                                             x_bf16(x_dtype))))


def _integrate_dense_cuda(
    act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b, L_steps, l1,
):
    """Launch csrc/traj_dense.cu once for the whole trajectory, and no other
    device op: the kernel reads every per-layer input where it lies (strided
    over branches and chains, as the sampler's transposed views are; the
    step sizes and prior factors broadcast, as the sampler's expanded ones
    are) and writes the end of the trajectory into one new buffer, returned
    as per-layer views."""
    dev, xT = xT.device, xT.contiguous()
    xb = _check_x(xT, xT.shape, dev)
    G, C, m, n, k0, s, depth = _dense_shape(xT, weights, traj_dense_smem, "K6")
    code = ACT_CODES[act]
    plan = _k6_plan(dev.index, G, C, m, n, k0, s, depth, code, xb)
    scratch = _scratch(dev, ("K6", dev.index, G, C, m, n, k0, s, depth, xb), plan[7])
    if dense_deep(k0, s, depth):
        return _integrate_dense_deep(act, xT, targets, err, weights, biases, p_w, p_b, eps_w,
                                     eps_b, lam_w, lam_b, L_steps, l1, scratch, plan[7], xb)
    # the layers in the kernel's slots W0, b0, W1, b1, w_out (W1, b1 absent at depth 0)
    shapes = layer_shapes(G, C, m, k0, s, depth)
    sizes = [0 if sh is None else G * C * int(torch.Size(sh[2:]).numel()) for sh in shapes]
    out = torch.empty(2 * sum(sizes), dtype=torch.float32, device=dev)
    views, off = [], 0
    for sh, size in zip(shapes + shapes, sizes + sizes):
        views.append(None if sh is None else out[off : off + size].view(sh))
        off += size
    items = [(targets, "targets", (G, C, n), False), (err, "err", (G, C), False)]
    for name, ws, bs in (("weights", weights, biases), ("momenta", p_w, p_b),
                         ("eps", eps_w, eps_b), ("lam", lam_w, lam_b)):
        items += [(t, f"{name}[{k}]", sh, name in ("eps", "lam"))
                  for k, (t, sh) in enumerate(zip(layer_slots(ws, bs, depth), shapes))]
    items += [(v, "out", sh, False) for v, sh in zip(views, shapes + shapes)]
    keep, ptrs, strides = pass_instances(items, dev)
    vp = ctypes.c_void_p
    status = _build.lib().traj_dense_f32(
        vp(xT.data_ptr()), (vp * len(ptrs))(*ptrs), (ctypes.c_longlong * len(strides))(*strides),
        vp(scratch.data_ptr()), plan[7], G, C, m, n, k0, s, depth, int(L_steps), code,
        int(bool(l1)), xb, vp(_build.stream_ptr(xT)),
    )
    _build.check(status, "traj_dense_f32")
    integrate_chains.launches += 1
    integrate_chains.xbf16_launches += xb

    def layers(vs):
        mid = (vs[2],) if depth else ()
        return (vs[0],) + mid + (vs[4],), (vs[1],) + ((vs[3],) if depth else ())

    w_f, b_f = layers(views[:5])
    pw_f, pb_f = layers(views[5:])
    return w_f, b_f, pw_f, pb_f


def _integrate_dense_deep(act, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w,
                          lam_b, L_steps, l1, scratch, nbytes, xb):
    """K6's deep design (depth 2 or more, or a padded width of 33-64;
    csrc/dense_deep.cuh): the weights, momenta, step sizes and prior
    factors concatenated into flat [G, C, P] copies (four device ops), the
    targets and err read where they lie, one cooperative launch that
    integrates the copies of the weights and momenta in place; returns
    per-layer views of them."""
    G, m, n = xT.shape
    C, depth = weights[0].shape[1], len(weights) - 2
    k0, s = weights[0].shape[-1], weights[-1].shape[-2]
    dev = xT.device
    w, pw = flat_params(weights, biases), flat_params(p_w, p_b)
    eps, lam = flat_params(eps_w, eps_b), flat_params(lam_w, lam_b)
    P = w.shape[-1]
    for name, t in (("weights", w), ("momenta", pw), ("eps", eps), ("lam", lam)):
        _check(t, name, torch.float32, (G, C, P), dev)
    keep, ptrs, strides = pass_instances(
        [(targets, "targets", (G, C, n), False), (err, "err", (G, C), False)], dev)
    vp = ctypes.c_void_p
    status = _build.lib().traj_dense_deep_f32(
        vp(xT.data_ptr()), (vp * 2)(*ptrs), (ctypes.c_longlong * 8)(*strides), vp(w.data_ptr()),
        vp(pw.data_ptr()), vp(eps.data_ptr()), vp(lam.data_ptr()), vp(scratch.data_ptr()),
        nbytes, G, C, m, n, k0, s, depth, int(L_steps), ACT_CODES[act], int(bool(l1)), xb,
        vp(_build.stream_ptr(xT)),
    )
    _build.check(status, "traj_dense_deep_f32")
    integrate_chains.launches += 1
    integrate_chains.xbf16_launches += xb
    w_f, b_f = unflat_params(w, weights, biases)
    pw_f, pb_f = unflat_params(pw, weights, biases)
    return w_f, b_f, pw_f, pb_f


def integrate_chains(
    act_name, xT, targets, err, weights, biases, p_w, p_b, eps_w, eps_b, lam_w, lam_b,
    L_steps, l1=False,
):
    """Integrate L leapfrog steps for all (branch, chain) pairs on dense
    feature-major X, same contract as the JAX package's: xT [G, m_pad, n]
    (f32 or bf16);
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
integrate_chains.xbf16_launches = 0  # those of them on bf16 X
