"""Goursat PDE at dyadic order ≥ 6 as a chain of 64×64 block hops: K8 and
its plain twin.

Port of ``sigsvgd_tpu/kernels/pallas_mxu_chain.py``. With ``z = inc/4^λ``
per coarse cell and m = 64, every block hop ``(I, J)`` of a pair maps its
129 input nodes (the south row from the hop below, the west column from the
hop to the left) to its 129 output nodes:

    U_d = M_d[:, :128] · bf16(in[:128])  +  M_d[:, 128] · in[128]
    out = Σ_{d=0..D} z^d U_d

with the bf16 × bf16 product accumulated in fp32, the last node's rank-1
term in fp32, and ``z^d`` built by repeated multiplication (``pow``'s VJP
at z = 0 is NaN). The value is node m of the last hop's north row. The VJP
recomputes the chain, then sweeps it back: ``dz += Σ_d d·z^{d-1}·Σ_f
U_d[f]·d_out[f]`` and the input cotangent ``Σ_d M_dᵀ[:128] · bf16(z^d·d_out)
+ Σ_d M_d[:, 128]·(z^d·d_out)`` (fp32 for the last node). The twin rounds to
bf16 in exactly these places, so twin and kernel differ only by the order
of their fp32 sums.

:func:`solve_goursat_pde_mxu_chain` is a ``torch.autograd.Function`` on the
scaled increments: a CPU tensor runs the twin's forward and backward, a
CUDA tensor launches the forward kernel and, for the gradient, the backward
kernel of ``csrc/mxu_chain.cu`` (counted by ``mxu_chain_fwd.launches`` and
``mxu_chain_bwd.launches``), or raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ._build import load

_M = 64            # block edge (fine cells); the contraction is 2m = 128
_NB = 2 * _M + 1   # nodes per hop input/output vector
_FP = _NB + 7      # the JAX package's degree-slice height (136)
MAX_HOPS = 64      # hops per pair K8 takes

_ROWS = 144        # csrc/mxu_chain.cu's slice height (9 k-steps of d_in's product)


@lru_cache(maxsize=4)
def _stacked_polys(degree: int):
    """``(Mstack [R, 128], MstackT [128, R], Mlast [R, 1])`` float32 numpy,
    ``R = (degree+1)·136``, laid out as the JAX package's: rows ``d·136+f``
    hold ``M_d[f, :128]`` (zero rows between slices), ``Mlast`` holds
    ``M_d[f, 128]``. ``Mstack`` is rounded to bf16 where it is used."""
    from .sigkernel import _propagator_polys

    Md = _propagator_polys(_M, degree)
    R = (degree + 1) * _FP
    mstack = np.zeros((R, 128), np.float32)
    mlast = np.zeros((R, 1), np.float32)
    for d in range(degree + 1):
        mstack[d * _FP: d * _FP + _NB] = Md[d, :, :128]
        mlast[d * _FP: d * _FP + _NB] = Md[d, :, 128][:, None]
    return mstack, np.ascontiguousarray(mstack.T), mlast


def chain_supported(lx1: int, ly1: int, dyadic_order: int) -> bool:
    """Shapes K8 takes: dyadic order ≥ 6 (the refinement is a multiple of
    the 64-wide block) and at most ``MAX_HOPS`` block hops per pair. The
    north rows and kept hop inputs go to per-block device scratch where
    shared memory cannot hold them (:func:`chain_plan`), so the envelope is
    wider than the TPU's VMEM-bound 16 hops, which it contains."""
    if dyadic_order < 6:
        return False
    sub = (1 << dyadic_order) // _M
    return (lx1 * sub) * (ly1 * sub) <= MAX_HOPS


def _geometry(lx1: int, ly1: int, dyadic_order: int):
    sub = (1 << dyadic_order) // _M
    return lx1 * sub, ly1 * sub, sub


def chain_flops(B: int, lx1: int, ly1: int, dyadic_order: int, degree: int = 10,
                backward: bool = False) -> tuple:
    """``(bf16 tensor-core operations, fp32 operations)`` a call needs,
    counting the 129 logical rows (not the padding). Per hop and pair the
    forward does one product of ``2·(D+1)·129·128`` and ``(2D+1)·129·2``
    fp32 operations for the rank-1 node and the degree sum. The backward
    recomputes the forward chain (its only inputs are z and the output
    cotangent), rebuilds ``U_d`` for d ≥ 1, and pulls the cotangent back
    through one transposed product of the same size, with fp32 work for the
    dz sums (``4D·129``), the weighted cotangent (``D·129``) and the last
    node (``2(D+1)·129``)."""
    nbx, nby, _ = _geometry(lx1, ly1, dyadic_order)
    hops = B * nbx * nby
    D1 = degree + 1
    prod = 2.0 * D1 * _NB * 128
    fwd32 = (2 * degree + 1) * _NB * 2.0
    if not backward:
        return hops * prod, hops * fwd32
    bf16 = prod + 2.0 * degree * _NB * 128 + prod
    fp32 = fwd32 + degree * _NB * 2.0 + 4.0 * degree * _NB + degree * _NB + 2.0 * D1 * _NB
    return hops * bf16, hops * fp32


def chain_bytes(B: int, lx1: int, ly1: int, backward: bool = False) -> float:
    """Bytes a call must move: z read once and k written once (forward);
    z and the cotangent read once, dz written once (backward). The basis
    (0.4 MB, shared by every pair) is not counted."""
    nc = lx1 * ly1
    if not backward:
        return 4.0 * B * (nc + 1)
    return 4.0 * B * (2 * nc + 1)


# ---------------------------------------------------------------------------
# Plain PyTorch twin.
# ---------------------------------------------------------------------------

_basis_cache: dict = {}


def _basis(degree: int, device):
    """``(mm [D+1, 129, 128] fp32 holding bf16 values, ml [D+1, 129])``."""
    key = ("plain", degree, str(device))
    if key not in _basis_cache:
        from .sigkernel import _propagator_polys

        Md = torch.from_numpy(_propagator_polys(_M, degree))
        mm = Md[:, :, :128].to(torch.bfloat16).to(torch.float32)
        _basis_cache[key] = (mm.to(device).contiguous(),
                             Md[:, :, 128].to(device).contiguous())
    return _basis_cache[key]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _hop_u(inp: torch.Tensor, mm: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """``U [B, D+1, 129]`` of hop inputs ``inp [B, 129]``."""
    D1 = mm.shape[0]
    u = (_bf16(inp[:, :128]) @ mm.reshape(D1 * _NB, 128).T).reshape(-1, D1, _NB)
    return u + ml[None] * inp[:, 128, None, None]


def _plain_forward(z, nbx, nby, sub, ly1, degree, keep_inputs=False):
    """``k [B]`` and, with ``keep_inputs``, every hop's input ``[B, 129]``
    in hop order ``J·nbx + I``."""
    mm, ml = _basis(degree, z.device)
    B = z.shape[0]
    ones = torch.ones(B, _NB, dtype=z.dtype, device=z.device)
    north = [ones[:, : _M + 1]] * nbx
    inputs = []
    for J in range(nby):
        west = ones[:, _M + 1:]
        for I in range(nbx):
            inp = torch.cat([north[I], west], dim=1)
            if keep_inputs:
                inputs.append(inp)
            u = _hop_u(inp, mm, ml)
            zc = z[:, (I // sub) * ly1 + (J // sub), None]
            out, zp = u[:, 0], zc
            for d in range(1, degree + 1):
                out = out + zp * u[:, d]
                zp = zp * zc
            north[I], west = out[:, : _M + 1], out[:, _M + 1:]
    return north[nbx - 1][:, _M], inputs


def _plain_backward(z, gout, nbx, nby, sub, ly1, degree):
    """``dz [B, nc]``: the recompute and reverse sweep of the K8 backward."""
    mm, ml = _basis(degree, z.device)
    B = z.shape[0]
    _, inputs = _plain_forward(z, nbx, nby, sub, ly1, degree, keep_inputs=True)
    zeros = torch.zeros(B, _NB, dtype=z.dtype, device=z.device)
    d_north = [zeros[:, : _M + 1]] * nbx
    d_north[nbx - 1] = d_north[nbx - 1].clone()
    d_north[nbx - 1][:, _M] = gout
    dz = torch.zeros_like(z)
    for J in range(nby - 1, -1, -1):
        d_west = zeros[:, _M + 1:]
        for I in range(nbx - 1, -1, -1):
            d_out = torch.cat([d_north[I], d_west], dim=1)
            u = _hop_u(inputs[J * nbx + I], mm, ml)
            cidx = (I // sub) * ly1 + (J // sub)
            zc = z[:, cidx]
            zp = torch.ones_like(zc)
            dz_acc = torch.zeros_like(zc)
            ws = [d_out]
            for d in range(1, degree + 1):
                dzp = torch.sum(u[:, d] * d_out, dim=1)
                dz_acc = dz_acc + float(d) * zp * dzp
                zp = zp * zc
                ws.append(zp[:, None] * d_out)
            dz[:, cidx] += dz_acc
            w = torch.stack(ws, dim=1)  # [B, D+1, 129]
            d_main = _bf16(w).reshape(B, -1) @ mm.reshape(-1, 128)
            d_last = torch.sum(ml[None] * w, dim=(1, 2))
            d_north[I] = d_main[:, : _M + 1]
            d_west = torch.cat([d_main[:, _M + 1:], d_last[:, None]], dim=1)
    return dz


class _ChainPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, nbx, nby, sub, ly1, degree):
        ctx.save_for_backward(z)
        ctx.geom = (nbx, nby, sub, ly1, degree)
        return _plain_forward(z, nbx, nby, sub, ly1, degree)[0]

    @staticmethod
    def backward(ctx, gout):
        (z,) = ctx.saved_tensors
        return (_plain_backward(z, gout.contiguous(), *ctx.geom),) + (None,) * 5


def _check(inc: torch.Tensor, dyadic_order: int):
    b, lx1, ly1 = inc.shape
    if not chain_supported(lx1, ly1, dyadic_order):
        raise ValueError(
            f"the hop-chain solver needs dyadic_order >= 6 and at most {MAX_HOPS} "
            f"64-wide block hops; got paths of {lx1 + 1}x{ly1 + 1} nodes at "
            f"dyadic_order={dyadic_order}"
        )
    nbx, nby, sub = _geometry(lx1, ly1, dyadic_order)
    z = (inc / float(4 ** dyadic_order)).reshape(b, lx1 * ly1)
    return z, (nbx, nby, sub, ly1)


def solve_goursat_pde_mxu_chain_plain(inc: torch.Tensor, dyadic_order: int,
                                      degree: int = 10) -> torch.Tensor:
    """The K8 contract in plain PyTorch, on any device, differentiable
    (its backward is the kernel's sweep): ``inc [B, lx1, ly1]`` → ``[B]``.
    It holds every hop's ``U`` (``[B, D+1, 129]``), so callers at 10⁶ pairs
    take the pairs in chunks."""
    z, geom = _check(inc, dyadic_order)
    return _ChainPlain.apply(z, *geom, degree)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

SLICE_BYTES = 2 * _ROWS * 128   # one degree slice M_d, bf16 [144, 128]
WG_PAIRS = 64                   # pairs a consumer warpgroup (wgmma's M)
WG_THREADS = 128
RING_STAGES = 3                 # slices in flight in a block's ring
SMEM_LIMIT = 232448             # dynamic shared memory a block may take
SMS = 132                       # H100 SXM
_SLOT_BYTES = 9 * 16 * WG_THREADS   # a north or kept-input slot of a warpgroup


def pack_slices(main: torch.Tensor) -> torch.Tensor:
    """``main [D1, 144, 128]`` (fp32 holding the basis) → the kernel's
    staged layout, bf16 ``[D1, 2, 144, 64]``: slice d is two column blocks
    (e < 64, e ≥ 64) of 144 rows f of 128 bytes, 16-byte chunk c of row f
    stored at chunk ``c ^ (f % 8)`` (the 128-byte swizzle of the row-major
    address). One bulk copy a slice puts it in shared memory as the wgmma
    descriptors of ``csrc/mxu_chain.cu`` read it: K-major for ``U_d``,
    MN-major for ``d_in``."""
    D1 = main.shape[0]
    x = main.to(torch.bfloat16).reshape(D1, _ROWS, 2, 8, 8).permute(0, 2, 1, 3, 4)
    f = torch.arange(_ROWS)[:, None]
    src = torch.arange(8)[None, :] ^ (f % 8)
    return x[:, :, f.expand(_ROWS, 8), src].contiguous()


def kernel_basis(degree: int, device):
    """The kernel's basis on ``device``: the packed degree slices of
    :func:`pack_slices` (``M_d`` rows padded to 144 with zeros) and
    ``mlast [D+1, 144]`` fp32 (``M_d[f, 128]``)."""
    key = ("kernel", degree, str(device))
    if key not in _basis_cache:
        from .sigkernel import _propagator_polys

        Md = torch.from_numpy(_propagator_polys(_M, degree))
        D1 = degree + 1
        main = torch.zeros(D1, _ROWS, 128)
        main[:, :_NB] = Md[:, :, :128]
        mlast = torch.zeros(D1, _ROWS)
        mlast[:, :_NB] = Md[:, :, 128]
        _basis_cache[key] = (pack_slices(main).to(device), mlast.to(device).contiguous())
    return _basis_cache[key]


@dataclass(frozen=True)
class ChainPlan:
    """How K8 lays a call out (``csrc/mxu_chain.cu``): ``warpgroups``
    consumer warpgroups of 64 pairs a block beside one producer warpgroup,
    ``stages`` ring slices, one persistent block an SM walking the tiles of
    ``pairs_per_block`` pairs; each thread's north slots (and, in the
    backward, each hop's kept input) in shared memory where they fit, else
    in per-block device scratch; and the basis bytes read through L2."""

    warpgroups: int
    pairs_per_block: int
    threads: int
    stages: int
    tiles: int
    blocks: int
    north_in_smem: bool
    kept_in_smem: bool
    smem_bytes: int
    north_scratch_bytes: int
    kept_scratch_bytes: int
    slices_per_tile: int
    basis_l2_bytes: int


def chain_plan(B: int, nc: int, nbx: int, nby: int, degree: int = 10,
               backward: bool = False, sms: int = SMS) -> ChainPlan:
    """K8's launch plan for ``B`` pairs of ``nbx × nby`` hops on a card of
    ``sms`` SMs. Two consumer warpgroups a block (128 pairs a staged slice)
    when that still gives every SM a tile, else one, so a small ``B`` (the
    planning run's 400 pairs) spreads over as many SMs as it can."""
    D1 = degree + 1
    hops = nbx * nby
    wgs = 2 if -(-B // (2 * WG_PAIRS)) >= sms else 1
    pairs = wgs * WG_PAIRS
    tiles = max(1, -(-B // pairs))
    blocks = min(tiles, sms)
    smem = 1024 + RING_STAGES * SLICE_BYTES + D1 * _ROWS * 4 + 16 * RING_STAGES
    north = wgs * nbx * _SLOT_BYTES if nby > 1 else 0
    north_in = 0 < north and smem + north <= SMEM_LIMIT
    smem += north if north_in else 0
    kept = wgs * hops * _SLOT_BYTES if backward else 0
    kept_in = 0 < kept and smem + kept <= SMEM_LIMIT
    smem += kept if kept_in else 0
    per_tile = (2 * hops - 1 if backward else hops) * D1
    return ChainPlan(
        warpgroups=wgs, pairs_per_block=pairs, threads=(wgs + 1) * WG_THREADS,
        stages=RING_STAGES, tiles=tiles, blocks=blocks, north_in_smem=north_in,
        kept_in_smem=kept_in, smem_bytes=smem,
        north_scratch_bytes=0 if north_in else blocks * north,
        kept_scratch_bytes=0 if kept_in else blocks * kept,
        slices_per_tile=per_tile, basis_l2_bytes=tiles * per_tile * SLICE_BYTES)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s ``mxu_chain_launch`` with its C signature."""
    lib.mxu_chain_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.mxu_chain_launch.restype = ctypes.c_int
    return lib


def _lib():
    return bind(load("mxu_chain"))


def _check_cuda(z: torch.Tensor, nbx: int, nby: int):
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("K8 takes contiguous fp32 scaled increments [B, nc]")
    if nbx * nby > MAX_HOPS:
        raise ValueError(f"K8 takes at most {MAX_HOPS} hops, got {nbx * nby}")


def device_plan(B: int, nc: int, nbx: int, nby: int, degree: int, backward: bool,
                device) -> ChainPlan:
    """:func:`chain_plan` on ``device``'s SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return chain_plan(B, nc, nbx, nby, degree, backward, sms)


def launch(z, gout, nbx, nby, sub, ly1, degree, backward, lib=None):
    """One launch of ``lib`` (default: ``csrc/mxu_chain.cu``'s library) on
    :func:`device_plan`, uncounted: ``k`` or, with ``backward``, ``dz``."""
    _check_cuda(z, nbx, nby)
    B, nc = z.shape
    basis, mlast = kernel_basis(degree, z.device)
    plan = device_plan(B, nc, nbx, nby, degree, backward, z.device)
    out = torch.empty((B, nc) if backward else (B,), dtype=z.dtype, device=z.device)

    def scratch(nbytes):
        return torch.empty(nbytes, dtype=torch.uint8, device=z.device) if nbytes else None

    north, kept = scratch(plan.north_scratch_bytes), scratch(plan.kept_scratch_bytes)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = (lib or _lib()).mxu_chain_launch(
        int(backward), z.data_ptr(), gout.data_ptr() if backward else None,
        basis.data_ptr(), mlast.data_ptr(), out.data_ptr(),
        north.data_ptr() if north is not None else None,
        kept.data_ptr() if kept is not None else None,
        B, nc, nbx, nby, sub, ly1, degree + 1, plan.warpgroups, plan.stages,
        int(plan.north_in_smem), int(plan.kept_in_smem), plan.smem_bytes, plan.blocks,
        stream)
    if rc != 0:
        which = "backward" if backward else "forward"
        raise RuntimeError(f"K8 {which} launch failed: cudaError {rc}")
    return out


def mxu_chain_fwd(z: torch.Tensor, nbx: int, nby: int, sub: int, ly1: int,
                  degree: int = 10) -> torch.Tensor:
    """``k [B]`` from scaled increments ``z [B, nc]``: the twin's forward on
    a CPU tensor, K8's forward kernel on a CUDA tensor (one launch, counted
    in ``mxu_chain_fwd.launches``)."""
    if z.device.type == "cpu":
        return _plain_forward(z, nbx, nby, sub, ly1, degree)[0]
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    k = launch(z, None, nbx, nby, sub, ly1, degree, False)
    mxu_chain_fwd.launches += 1
    return k


def mxu_chain_bwd(z: torch.Tensor, gout: torch.Tensor, nbx: int, nby: int,
                  sub: int, ly1: int, degree: int = 10) -> torch.Tensor:
    """``dz [B, nc]`` for the cotangent ``gout [B]`` of ``k``: the twin's
    sweep on a CPU tensor, K8's backward kernel on a CUDA tensor (one
    launch, counted in ``mxu_chain_bwd.launches``)."""
    if z.device.type == "cpu":
        return _plain_backward(z, gout, nbx, nby, sub, ly1, degree)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    dz = launch(z, gout.to(torch.float32).contiguous(), nbx, nby, sub, ly1, degree, True)
    mxu_chain_bwd.launches += 1
    return dz


mxu_chain_fwd.launches = 0
mxu_chain_bwd.launches = 0


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, nbx, nby, sub, ly1, degree):
        ctx.save_for_backward(z)
        ctx.geom = (nbx, nby, sub, ly1, degree)
        return mxu_chain_fwd(z, nbx, nby, sub, ly1, degree)

    @staticmethod
    def backward(ctx, gout):
        (z,) = ctx.saved_tensors
        return (mxu_chain_bwd(z, gout, *ctx.geom),) + (None,) * 5


def solve_goursat_pde_mxu_chain(inc: torch.Tensor, dyadic_order: int,
                                degree: int = 10) -> torch.Tensor:
    """Hop-chain PDE solve ``inc [B, lx1, ly1]`` → ``[B]`` with K8's
    precision (bf16 products, fp32 accumulation), differentiable: its
    forward and backward are K8's two kernels on the card and the twin's
    on the CPU. Raises ``ValueError`` outside :func:`chain_supported`."""
    z, geom = _check(inc, dyadic_order)
    return _Chain.apply(z.contiguous(), *geom, degree)
