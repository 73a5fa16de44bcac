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
from functools import lru_cache

import numpy as np
import torch

from ._build import load

_M = 64            # block edge (fine cells); the contraction is 2m = 128
_NB = 2 * _M + 1   # nodes per hop input/output vector
_FP = _NB + 7      # the JAX package's degree-slice height (136)
MAX_HOPS = 64      # hops per pair K8 takes (its scratch is in device memory)

# csrc/mxu_chain.cu tile: P pairs per block, output rows padded to 9 m-tiles
TILE_PAIRS = 64
_ROWS = 144


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
    hop inputs and north rows live in device scratch and only ``z``/``dz``
    grow the shared memory (2 KB per coarse cell), so the envelope is wider
    than the TPU's VMEM-bound 16 hops, which it contains."""
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


def _frag_a(A: torch.Tensor) -> torch.Tensor:
    """Matrices ``A [n, R, K]`` (R, K multiples of 16) → bf16
    ``[n, R/16, K/16, 32, 8]``: lane ℓ's ``mma.m16n8k16`` A fragment of each
    16×16 tile, in register order (rows g and g+8, columns 2q, 2q+1 and
    2q+8, 2q+9 with g = ℓ/4, q = ℓ%4), one 16-byte load per lane."""
    n, R, K = A.shape
    t = A.reshape(n, R // 16, 16, K // 16, 16).permute(0, 1, 3, 2, 4)
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    cols = torch.stack([2 * q, 2 * q + 1, 2 * q, 2 * q + 1,
                        2 * q + 8, 2 * q + 9, 2 * q + 8, 2 * q + 9], 1)
    return t[:, :, :, rows, cols].to(torch.bfloat16).contiguous()


def kernel_basis(degree: int, device):
    """The kernel's basis on ``device``: forward fragments of ``M_d``
    (``[D+1, 144, 128]``, rows padded with zeros), backward fragments of
    ``M_dᵀ`` (``[D+1, 128, 144]``) and ``mlast [D+1, 144]`` fp32."""
    key = ("kernel", degree, str(device))
    if key not in _basis_cache:
        from .sigkernel import _propagator_polys

        Md = torch.from_numpy(_propagator_polys(_M, degree))
        D1 = degree + 1
        main = torch.zeros(D1, _ROWS, 128)
        main[:, :_NB] = Md[:, :, :128]
        mlast = torch.zeros(D1, _ROWS)
        mlast[:, :_NB] = Md[:, :, 128]
        _basis_cache[key] = (_frag_a(main).to(device),
                             _frag_a(main.transpose(1, 2).contiguous()).to(device),
                             mlast.to(device).contiguous())
    return _basis_cache[key]


def _lib():
    lib = load("mxu_chain")
    lib.mxu_chain_blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mxu_chain_blocks.restype = ctypes.c_int
    lib.mxu_chain_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mxu_chain_fwd.restype = ctypes.c_int
    lib.mxu_chain_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mxu_chain_bwd.restype = ctypes.c_int
    return lib


def chain_blocks(nc: int, degree: int, backward: bool) -> int:
    """Resident blocks of the forward or backward kernel on the current
    card (blocks per SM by occupancy × SMs): each walks the pair tiles
    ``tile = block, block + grid, ...`` and owns one slice of scratch."""
    blocks = ctypes.c_int(0)
    rc = _lib().mxu_chain_blocks(nc, degree + 1, int(backward), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K8 occupancy query failed: cudaError {rc}")
    return blocks.value


def _check_cuda(z: torch.Tensor, nbx: int, nby: int):
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("K8 takes contiguous fp32 scaled increments [B, nc]")
    if nbx * nby > MAX_HOPS:
        raise ValueError(f"K8 takes at most {MAX_HOPS} hops, got {nbx * nby}")


def _grid(B: int, nc: int, degree: int, backward: bool) -> int:
    tiles = -(-B // TILE_PAIRS)
    return max(1, min(tiles, chain_blocks(nc, degree, backward)))


def mxu_chain_fwd(z: torch.Tensor, nbx: int, nby: int, sub: int, ly1: int,
                  degree: int = 10) -> torch.Tensor:
    """``k [B]`` from scaled increments ``z [B, nc]``: the twin's forward on
    a CPU tensor, K8's forward kernel on a CUDA tensor (one launch, counted
    in ``mxu_chain_fwd.launches``)."""
    if z.device.type == "cpu":
        return _plain_forward(z, nbx, nby, sub, ly1, degree)[0]
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    _check_cuda(z, nbx, nby)
    B, nc = z.shape
    afrag, _, mlast = kernel_basis(degree, z.device)
    blocks = _grid(B, nc, degree, False)
    k = torch.empty(B, dtype=z.dtype, device=z.device)
    north = torch.empty(blocks * nbx * (_M + 1) * TILE_PAIRS, dtype=z.dtype,
                        device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _lib().mxu_chain_fwd(z.data_ptr(), afrag.data_ptr(), mlast.data_ptr(),
                              k.data_ptr(), north.data_ptr(), B, nc, nbx, nby, sub,
                              ly1, degree + 1, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"K8 forward launch failed: cudaError {rc}")
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
    _check_cuda(z, nbx, nby)
    gout = gout.to(torch.float32).contiguous()
    B, nc = z.shape
    afrag, atfrag, mlast = kernel_basis(degree, z.device)
    blocks = _grid(B, nc, degree, True)
    dz = torch.empty_like(z)
    north = torch.empty(blocks * nbx * (_M + 1) * TILE_PAIRS, dtype=z.dtype,
                        device=z.device)
    # per block and hop: the bf16 input [P, 136] and its fp32 last node [P]
    inputs = torch.empty(blocks * nbx * nby * TILE_PAIRS * (136 * 2 + 4),
                         dtype=torch.uint8, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _lib().mxu_chain_bwd(z.data_ptr(), gout.data_ptr(), afrag.data_ptr(),
                              atfrag.data_ptr(), mlast.data_ptr(), dz.data_ptr(),
                              north.data_ptr(), inputs.data_ptr(), B, nc, nbx, nby,
                              sub, ly1, degree + 1, blocks, stream)
    if rc != 0:
        raise RuntimeError(f"K8 backward launch failed: cudaError {rc}")
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
