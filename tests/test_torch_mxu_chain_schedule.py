"""K8's data flow (``csrc/mxu_chain.cu``) modelled on the CPU.

* The host packing: :func:`pack_slices` lays each degree slice out as the
  kernel's wgmma descriptors read it. Gathering the packed bytes through
  the K-major map (``U_d``'s operand, B[e, f]) gives bf16(M_d)ᵀ and through
  the MN-major map (``d_in``'s operand, B[f, e]) bf16(M_d), bit for bit,
  rows 129-143 zero. The maps are the canonical 128-byte-swizzled layouts
  with the kernel's descriptor offsets (8-row groups 1024 bytes apart, the
  two 64-wide column blocks 18,432 bytes apart, a K-major k-step 32 bytes
  into a row, an MN-major one 2,048 bytes down).
* One consumer warpgroup's step sequence, pairs as rows, registers in the
  accumulator layout (thread t holds rows 16w+g and 16w+g+8, columns
  8j+2q, 8j+2q+1 of n-tile j): the per-degree product in two 72-row chunks
  with the rank-1 term and the degree sum; the hand-off of the north rows
  through the thread's own slot and of the east rows in registers into the
  next hop's bf16 input (node 64 at q = 0 from the slot, node 128 from the
  quad's first lane); the reverse sweep's one pass a degree (d_in with the
  last node's fp32 sum, then U_d in two chunks and its dz term); dz and the
  last node summed over the thread's columns, then over its quad in the
  kernel's order. Its k and dz are held against ``_plain_forward`` /
  ``_plain_backward`` at K8's tolerance (scaled 1e-3 / 2e-3); the largest
  seen were 3.6e-9 for k (16 hops) and 5.1e-5 for dz (64 hops). ~12 s on
  one CPU thread, which its fixture sets.
* :func:`chain_plan` at the planning shape, at the planning run's 400
  pairs, and for 1..64 hops, within the block's shared memory.

No JAX: the twin is held against JAX in ``test_torch_mxu_chain.py``.
"""
import numpy as np
import pytest
import torch

from sigsvgd_tpu_torch.kernels import mxu_chain as mc
from sigsvgd_tpu_torch.kernels.sigkernel import _propagator_polys

ROWS, BLK = 144, 144 * 128
K8_TOL = (1e-3, 2e-3)


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """The model runs many small tensor ops: on one thread; the thread count
    is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _main(degree):
    Md = torch.from_numpy(_propagator_polys(64, degree))
    main = torch.zeros(degree + 1, ROWS, 128)
    main[:, :129] = Md[:, :, :128]
    return main, Md


def swizzle128(addr):
    """The 128-byte swizzle of a shared-memory byte address, as wgmma reads
    a ``SWIZZLE_128B`` operand: its 16-byte chunk (bits 4-6) XOR its row in
    the 1 KB atom (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _gather(packed_d, addr):
    """bf16 values of one packed slice at byte addresses ``addr`` (swizzled)."""
    flat = packed_d.reshape(-1)
    return flat[swizzle128(addr) // 2].to(torch.float32)


def k_major_addr():
    """Byte address of B[e, f] = M_d[f, e] as U_d's wgmma reads it: k-step
    ks = e // 16 at column block ks // 4 and 32·(ks % 4) bytes into the
    row, the chunk's rows f0.. (f0 = 0 or 72) 128 bytes apart in 8-row
    groups 1024 apart, the step's 16 columns 2 bytes apart."""
    e = torch.arange(128)[:, None]
    f = torch.arange(ROWS)[None, :]
    ks, k = e // 16, e % 16
    f0 = torch.where(f < 72, 0, 72)
    n = f - f0
    start = (ks // 4) * BLK + f0 * 128 + (ks % 4) * 32
    return start + (n % 8) * 128 + (n // 8) * 1024 + (k % 8) * 2 + (k // 8) * 16


def mn_major_addr():
    """Byte address of B[f, e] = M_d[f, e] as d_in's wgmma reads it: k-step
    ks = f // 16 at 2048·ks, the step's rows in 8-row groups (SBO 1024),
    columns e 2 bytes apart in 16-byte chunks of a 64-wide block, the two
    blocks BLK apart (LBO)."""
    f = torch.arange(ROWS)[:, None]
    e = torch.arange(128)[None, :]
    ks, k = f // 16, f % 16
    return (ks * 2048 + (e % 8) * 2 + ((e // 8) % 8) * 16 + (e // 64) * BLK
            + (k % 8) * 128 + (k // 8) * 1024)


@pytest.mark.parametrize("degree", [10, 6])
def test_packed_slices_unpack_to_the_basis_both_ways(degree):
    packed, mlast = mc.kernel_basis(degree, "cpu")
    main, Md = _main(degree)
    assert packed.dtype == torch.bfloat16 and packed[0].numel() * 2 == mc.SLICE_BYTES
    ka, na = k_major_addr(), mn_major_addr()
    for d in range(degree + 1):
        want = _bf16(main[d])                       # [144, 128], rows ≥ 129 zero
        assert torch.equal(_gather(packed[d], ka), want.T)
        assert torch.equal(_gather(packed[d], na), want)
        assert not want[129:].any()
    assert torch.equal(mlast[:, :129], Md[:, :, 128]) and not mlast[:, 129:].any()


def test_swizzle_keeps_each_row_in_its_128_bytes():
    addr = torch.arange(2 * BLK // 2) * 2
    sw = swizzle128(addr)
    assert torch.equal(sw // 128, addr // 128)
    assert torch.equal(torch.sort(sw).values, addr)


# ---------------------------------------------------------------------------
# One consumer warpgroup, registers in the accumulator layout.
# ---------------------------------------------------------------------------

_T = torch.arange(128)
_Q = _T % 4
_R0 = 16 * (_T // 32) + (_T % 32) // 4
_C = torch.arange(4)
ROW = torch.where(_C[None] < 2, _R0[:, None], _R0[:, None] + 8)            # [128, 4]
COL = 8 * torch.arange(18)[None, :, None] + 2 * _Q[:, None, None] + (_C & 1)  # [128, 18, 4]
Q0 = _Q == 0
LEAD = _T & ~3                                  # the first lane of each quad


def to_acc(mat, j0, nj, f0=0):
    """Matrix ``[W, 64, N]`` → registers ``[W, 128, nj, 4]`` of n-tiles
    j0..j0+nj-1 (columns offset by f0)."""
    r = ROW[:, None, :].expand(128, nj, 4)
    return mat[:, r, COL[:, j0:j0 + nj] - f0]


def from_acc(acc, ncol):
    """Registers ``[W, 128, nj, 4]`` of n-tiles 0.. → matrix ``[W, 64, ncol]``."""
    W, _, nj, _ = acc.shape
    mat = acc.new_zeros(W, 64, ncol)
    mat[:, ROW[:, None, :].expand(128, nj, 4), COL[:, :nj]] = acc
    return mat


def rowsel(v):
    """Per-row values ``[W, 128, 2]`` → ``[W, 128, 1, 4]`` by element c."""
    return v[:, :, None, [0, 0, 1, 1]]


class Warpgroups:
    """``W`` consumer warpgroups of 64 pairs, stepped as the kernel steps."""

    def __init__(self, z, nbx, nby, sub, ly1, degree):
        B, nc = z.shape
        self.W = -(-B // 64)
        zp = torch.zeros(self.W * 64, nc)
        zp[:B] = z
        self.z = zp.reshape(self.W, 64, nc)
        self.B, self.nc, self.geom = B, nc, (nbx, nby, sub, ly1)
        packed, self.mlast = mc.kernel_basis(degree, "cpu")
        ka, na = k_major_addr(), mn_major_addr()
        self.Bk = [_gather(packed[d], ka) for d in range(degree + 1)]   # [128, 144]
        self.Bmn = [_gather(packed[d], na) for d in range(degree + 1)]  # [144, 128]
        self.D1 = degree + 1

    def zc(self, I, J):
        nbx, nby, sub, ly1 = self.geom
        zz = self.z[:, :, (I // sub) * ly1 + J // sub]
        return torch.stack([zz[:, _R0], zz[:, _R0 + 8]], -1)           # [W, 128, 2]

    def u_chunk(self, a, il, d, half):
        """U_d over rows 72·half.. : the product, then the rank-1 term."""
        U = from_acc(a, 128) @ self.Bk[d][:, 72 * half:72 * half + 72]
        u = to_acc(U, 9 * half, 9, 72 * half)
        ml = self.mlast[d][COL[:, 9 * half:9 * half + 9]]
        return u + ml[None] * rowsel(il)

    def hop_input(self, out, north, I, J):
        a = torch.ones(self.W, 128, 16, 4)
        il = torch.ones(self.W, 128, 2)
        if I > 0:
            a[:, :, 8:16] = _bf16(out[:, :, 8:16])
            il = torch.stack([out[:, LEAD, 16, 0], out[:, LEAD, 16, 2]], -1)
        s = north[I] if J > 0 else torch.ones(self.W, 128, 10, 4)
        a[:, :, 0:8] = s[:, :, 0:8]
        a[:, Q0, 8, 0] = s[:, Q0, 8, 0]             # node 64 (q = 0) is south
        a[:, Q0, 8, 2] = s[:, Q0, 8, 2]
        return a, il

    def forward_hop(self, a, il, zc):
        out = torch.zeros(self.W, 128, 18, 4)
        zp = zc.clone()
        for d in range(self.D1):
            for half in (0, 1):
                u = self.u_chunk(a, il, d, half)
                sl = slice(9 * half, 9 * half + 9)
                out[:, :, sl] = u if d == 0 else out[:, :, sl] + rowsel(zp) * u
            if d > 0:
                zp = zp * zc
        return out

    def forward(self, keep=False):
        nbx, nby, _, _ = self.geom
        H = nbx * nby
        north, kept, out = {}, [], torch.zeros(self.W, 128, 18, 4)
        for h in range(H):
            J, I = divmod(h, nbx)
            a, il = self.hop_input(out, north, I, J)
            if keep:
                kept.append((a, il))
                if h == H - 1:
                    return kept
            out = self.forward_hop(a, il, self.zc(I, J))
            if J < nby - 1:
                north[I] = _bf16(out[:, :, 0:10])      # words 0..4: n-tiles 0..9
        k = torch.zeros(self.W, 64)
        k[:, _R0[Q0]] = out[:, Q0, 8, 0]
        k[:, _R0[Q0] + 8] = out[:, Q0, 8, 2]
        return k.reshape(-1)[: self.B]

    def backward(self, gout):
        nbx, nby, sub, ly1 = self.geom
        H = nbx * nby
        kept = self.forward(keep=True)
        g = torch.zeros(self.W * 64)
        g[: self.B] = gout
        g = g.reshape(self.W, 64)
        dz = torch.zeros(self.W, 64, self.nc)
        dnorth = {}
        din = torch.zeros(self.W, 128, 16, 4)
        dl = torch.zeros(self.W, 128, 2)
        for h in range(H - 1, -1, -1):
            J, I = divmod(h, nbx)
            dout = torch.zeros(self.W, 128, 17, 4)
            if I < nbx - 1:
                dout[:, :, 8:16] = din[:, :, 8:16]
                dout[:, Q0, 16, 0] = dl[:, Q0, 0]
                dout[:, Q0, 16, 2] = dl[:, Q0, 1]
            if J == nby - 1:
                top = I == nbx - 1
                dout[:, Q0, 8, 0] = g[:, _R0[Q0]] if top else 0.0
                dout[:, Q0, 8, 2] = g[:, _R0[Q0] + 8] if top else 0.0
            else:
                s = dnorth[I]
                dout[:, :, 0:8] = s[:, :, 0:8]
                dout[:, Q0, 8, 0] = s[:, Q0, 8, 0]
                dout[:, Q0, 8, 2] = s[:, Q0, 8, 2]
            a, il = kept[h]
            zc = self.zc(I, J)
            din = torch.zeros(self.W, 128, 16, 4)
            dl = torch.zeros(self.W, 128, 2)
            dzt = torch.zeros(self.W, 128, 2)
            zp = torch.ones(self.W, 128, 2)            # z^{d-1} entering degree d
            for d in range(self.D1):
                zd = zp if d == 0 else zp * zc
                w = torch.zeros(self.W, 128, 18, 4)
                w[:, :, :17] = rowsel(zd) * dout
                ml = self.mlast[d][COL[:, :17]]            # [128, 17, 4]
                for j in range(17):                        # the kernel's order
                    dl[..., 0] = dl[..., 0] + ml[:, j, 0] * w[:, :, j, 0]
                    dl[..., 0] = dl[..., 0] + ml[:, j, 1] * w[:, :, j, 1]
                    dl[..., 1] = dl[..., 1] + ml[:, j, 2] * w[:, :, j, 2]
                    dl[..., 1] = dl[..., 1] + ml[:, j, 3] * w[:, :, j, 3]
                din = din + to_acc(from_acc(_bf16(w), ROWS) @ self.Bmn[d], 0, 16)
                if d > 0:
                    part = torch.zeros(self.W, 128, 2)
                    for half in (0, 1):
                        u = self.u_chunk(a, il, d, half)
                        for j in range(9):
                            jg = 9 * half + j
                            if jg < 17:
                                part[..., 0] = part[..., 0] + u[:, :, j, 0] * dout[:, :, jg, 0]
                                part[..., 0] = part[..., 0] + u[:, :, j, 1] * dout[:, :, jg, 1]
                                part[..., 1] = part[..., 1] + u[:, :, j, 2] * dout[:, :, jg, 2]
                                part[..., 1] = part[..., 1] + u[:, :, j, 3] * dout[:, :, jg, 3]
                    dzt = dzt + (float(d) * zp) * part
                zp = zd
            # over the quad: v += v[t ^ 1]; v += v[t ^ 2]
            for v in (dzt, dl):
                v += v[:, _T ^ 1].clone()
                v += v[:, _T ^ 2].clone()
            cidx = (I // sub) * ly1 + J // sub
            dz[:, _R0[Q0], cidx] += dzt[:, Q0, 0]
            dz[:, _R0[Q0] + 8, cidx] += dzt[:, Q0, 1]
            if J > 0:
                dnorth[I] = din[:, :, 0:9].clone()
        return dz.reshape(-1, self.nc)[: self.B]


def _scaled(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("B,lx1,ly1,lam", [
    (70, 2, 2, 6),     # 4 hops, two warpgroups, the second ragged
    (5, 4, 4, 6),      # 16 hops
    (6, 2, 2, 7),      # 16 hops, two blocks per coarse cell side (sub = 2)
    (3, 8, 8, 6),      # MAX_HOPS
    (4, 1, 1, 6),      # one hop: no hand-off
])
def test_warpgroup_model_matches_the_twin(B, lx1, ly1, lam):
    rng = np.random.default_rng(B * 100 + lx1)
    inc = np.clip(rng.standard_normal((B, lx1, ly1)), -2, 2).astype(np.float32)
    inc[1] = 0.0                                   # a zero-increment pair: z = 0
    gout = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    z, geom = mc._check(torch.from_numpy(inc), lam)
    nbx, nby, sub, ly1g = geom
    assert nbx * nby <= mc.MAX_HOPS
    model = Warpgroups(z, nbx, nby, sub, ly1g, 10)
    k = model.forward()
    dz = model.backward(gout)
    kp = mc._plain_forward(z, nbx, nby, sub, ly1g, 10)[0]
    dp = mc._plain_backward(z, gout, nbx, nby, sub, ly1g, 10)
    assert torch.isfinite(k).all() and torch.isfinite(dz).all()
    assert _scaled(k, kp) <= K8_TOL[0], _scaled(k, kp)
    assert _scaled(dz, dp) <= K8_TOL[1], _scaled(dz, dp)
    assert torch.isfinite(dz[1]).all()


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------

def _old_basis_bytes(B, hops, backward):
    """The basis through L2 of the design before (64 pairs a tile, 11 slices
    a forward hop, 32 a backward hop)."""
    return -(-B // 64) * hops * (32 if backward else 11) * mc.SLICE_BYTES


@pytest.mark.parametrize("backward", [False, True])
def test_plan_at_the_planning_shape(backward):
    B = 1 << 20
    plan = mc.chain_plan(B, 4, 2, 2, 10, backward)
    assert (plan.warpgroups, plan.pairs_per_block, plan.threads) == (2, 128, 384)
    assert plan.tiles == B // 128 and plan.blocks == mc.SMS
    assert plan.north_in_smem and plan.north_scratch_bytes == 0
    assert plan.smem_bytes <= mc.SMEM_LIMIT
    assert plan.slices_per_tile == (7 if backward else 4) * 11
    assert plan.basis_l2_bytes == plan.tiles * plan.slices_per_tile * mc.SLICE_BYTES
    old = _old_basis_bytes(B, 4, backward)
    assert plan.basis_l2_bytes <= old / (3 if backward else 2)
    if backward:    # 4 hops of inputs do not fit beside the ring and the north rows
        assert not plan.kept_in_smem
        assert plan.kept_scratch_bytes == mc.SMS * 2 * 4 * 9 * 16 * 128


def test_plan_spreads_the_planning_run_over_sms():
    for backward in (False, True):
        plan = mc.chain_plan(400, 4, 2, 2, 10, backward)
        assert plan.warpgroups == 1 and plan.tiles == plan.blocks == 7
        assert plan.smem_bytes <= mc.SMEM_LIMIT
    assert mc.chain_plan(400, 4, 2, 2, 10, True).kept_in_smem


@pytest.mark.parametrize("backward", [False, True])
def test_plan_for_every_hop_count(backward):
    slot = 9 * 16 * 128
    for nbx in range(1, 65):
        for nby in range(1, mc.MAX_HOPS // nbx + 1):
            for B in (1, 400, 1 << 20):
                plan = mc.chain_plan(B, nbx * nby, nbx, nby, 10, backward)
                base = 1024 + 3 * mc.SLICE_BYTES + 11 * 144 * 4 + 16 * 3
                north = plan.warpgroups * nbx * slot if nby > 1 else 0
                kept = plan.warpgroups * nbx * nby * slot if backward else 0
                assert plan.smem_bytes <= mc.SMEM_LIMIT
                assert plan.smem_bytes == (base + north * plan.north_in_smem
                                           + kept * plan.kept_in_smem)
                assert plan.north_scratch_bytes == (0 if plan.north_in_smem
                                                    else plan.blocks * north)
                assert plan.kept_scratch_bytes == (0 if plan.kept_in_smem
                                                   else plan.blocks * kept)
                assert plan.blocks == min(plan.tiles, mc.SMS)
                assert plan.tiles * plan.pairs_per_block >= B
