"""Folded (lane-dense) grid layout and the fused serving sites.

Port of ``sgnn_tpu/ops/folded.py``. The layout is kept as it is there, so
the two packages can be compared byte for byte:

    fgrid [B, Z+2, Y+2, xq, 128]     lane l = xi * cpad + c

F = 128 / cpad voxels along x share a 128-lane row; a one-voxel zero halo
ring pads z and y; the x-block dimension is padded to
xq = roundup(ceil(X / F), 8) with zero tail blocks; dead lanes (channel
>= real_c) are zero; masks are FGrids whose 0/1 voxel value is
replicated over the voxel's cpad lanes. Since 128 = F * cpad, a row
(b, z, y) is also Xs = xq * F voxel slots of cpad channels: ``slots()``
is that view, and every op here is written on it.

The input scatter and the fused sites (conv, downconv, upconv, head,
multi-scale surface head; the first three also in their int8 mode,
``quantize=True``, with the weights of ``ops/quant.py``) run
the CUDA kernels of ``ops/kernels``, or their plain versions on the CPU.
The sites take kernel-ready weights prepared once by the ``prep_*``
functions below (the port's replacement for the JAX package's
record/replay weight stream).

``scatter_sparse_sharded`` and ``halo_exchange_z`` (port of :1772-1825)
serve a z-sharded slab: rows land on the rank that owns their z, and a
3^3 site's inputs get their z ring from the neighbours' planes.

The training sites at the end of the module (port of
``sgnn_tpu/ops/folded.py:1135-1769``) are ``torch.autograd.Function``s
with the JAX package's custom-VJP contracts: the 3^3 conv runs K7
(``conv_raw``) forward and for its input gradient; the fused BN -> conv
site runs K1 forward with a hand-written backward; every other site runs
its serving kernel forward and differentiates the plain composition at
the saved inputs. Under data parallelism every training BN sums its
moments over the data group (``bn_moments``'s ``group``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from sgnn_tpu_torch.ops.kernels import conv_raw as K_raw
from sgnn_tpu_torch.ops.kernels import conv_site as K_conv
from sgnn_tpu_torch.ops.kernels import downconv as K_down
from sgnn_tpu_torch.ops.kernels import head as K_head
from sgnn_tpu_torch.ops.kernels import scatter as K_scatter
from sgnn_tpu_torch.ops.kernels import surf_head as K_surf
from sgnn_tpu_torch.ops.kernels import upconv as K_up
from sgnn_tpu_torch.parallel import comm

LANES = 128
MAXC = 16  # channel padding of every prepared weight/affine array
BN_EPS = 1e-4  # scn's BatchNormReLU eps (not torch's 1e-5)
BN_MOMENTUM = 0.9  # running stats: new = m * old + (1 - m) * batch


@dataclasses.dataclass
class FGrid:
    """A folded grid. data [B, Z+2, Y+2, xq, 128]; see module docstring."""
    data: torch.Tensor
    dims: tuple  # logical (Z, Y, X)
    real_c: int
    cpad: int

    @property
    def fold(self) -> int:
        return LANES // self.cpad

    def with_data(self, data: torch.Tensor) -> "FGrid":
        return FGrid(data, self.dims, self.real_c, self.cpad)

    def slots(self) -> torch.Tensor:
        """View [B, Z+2, Y+2, xq * F, cpad]: one row per voxel slot."""
        B, Zp, Yp, xq, _ = self.data.shape
        return self.data.view(B, Zp, Yp, xq * self.fold, self.cpad)


def _xq_for(X: int, cpad: int) -> int:
    blocks = -(-X // (LANES // cpad))
    return -(-blocks // 8) * 8


def _halo(s: torch.Tensor, xs: int) -> torch.Tensor:
    """Slot view [B, Z, Y, n, c] -> [B, Z+2, Y+2, xs, c]: zero ring, x
    cropped or zero-padded to xs slots."""
    s = s[:, :, :, :xs]
    return nnf.pad(s, (0, 0, 0, xs - s.shape[3], 1, 1, 1, 1))


def _to_grid(s: torch.Tensor) -> torch.Tensor:
    B, Zp, Yp, n, c = s.shape
    return s.reshape(B, Zp, Yp, n * c // LANES, LANES)


# ------------------------------------------------------------ fold / unfold


def fold(dense: torch.Tensor, cpad: int = 16) -> FGrid:
    """[B, Z, Y, X, C] -> FGrid (adds halo, x tail, dead lanes)."""
    B, Z, Y, X, C = dense.shape
    xq = _xq_for(X, cpad)
    s = nnf.pad(dense, (0, cpad - C))
    return FGrid(_to_grid(_halo(s, xq * (LANES // cpad))), (Z, Y, X), C,
                 cpad)


def unfold(fg: FGrid) -> torch.Tensor:
    """FGrid -> [B, Z, Y, X, real_c]."""
    Z, Y, X = fg.dims
    return fg.slots()[:, 1:Z + 1, 1:Y + 1, :X, :fg.real_c]


def fold_mask(mask: torch.Tensor, cpad: int = 16,
              dtype: torch.dtype = torch.bfloat16) -> FGrid:
    """[B, Z, Y, X] bool -> 0/1 FGrid replicated across each voxel's lanes."""
    m = mask[..., None].to(dtype).expand(*mask.shape, cpad)
    return fold(m, cpad)


def scatter_sparse(locs: torch.Tensor, feats: torch.Tensor, num_valid: int,
                   dims: tuple, batch_size: int, cpad: int = 16,
                   dtype: torch.dtype = torch.bfloat16,
                   feat_bound: float = 3.0, impl: str | None = None
                   ) -> tuple[FGrid, FGrid]:
    """Sparse rows -> (feature FGrid, mask FGrid), the input boundary (K6).

    ``locs [cap, 4]`` (z, y, x, b) integer rows, the first ``num_valid``
    valid; ``feats [cap, 1]`` with |feats| < ``feat_bound``. Each value is
    encoded as feat + K (K the next power of two above the bound, so every
    valid voxel is > 0) in f32; the mask is the sign, and the bias comes
    off in the same pass (ops/folded.py:248-295).
    """
    cap, cin = feats.shape
    if cin != 1:
        raise ValueError(f"scatter_sparse: one input channel, got {cin}")
    K = float(2 ** int(np.ceil(np.log2(feat_bound + 1e-6))))
    if K <= feat_bound:
        K *= 2.0
    data, mdata = K_scatter.scatter(
        locs[:num_valid].long().contiguous(),
        feats[:num_valid].float().contiguous(), dims, batch_size, cpad,
        _xq_for(dims[2], cpad), dtype, K, impl=impl,
    )
    return FGrid(data, dims, cin, cpad), FGrid(mdata, dims, cpad, cpad)


def scatter_sparse_sharded(locs: torch.Tensor, feats: torch.Tensor,
                           num_valid: int, dims: tuple, batch_size: int,
                           group, cpad: int = 16,
                           dtype: torch.dtype = torch.bfloat16,
                           feat_bound: float = 3.0, impl: str | None = None
                           ) -> tuple[FGrid, FGrid]:
    """``scatter_sparse`` for a z-sharded slab (:1794-1825): ``dims`` the
    GLOBAL (Z, Y, X); rows land on the rank of ``group`` that owns their
    z, moved to its local z, and the rest are dropped; the FGrids are this
    rank's LOCAL ``[B, Z/n + 2, ...]`` slab (K6 on the local slab)."""
    Z, Y, X = dims
    n, i = comm.size(group), comm.index(group)
    if Z % n:
        raise ValueError(f"scatter_sparse_sharded: Z {Z} over {n} ranks")
    zl = Z // n
    loc = locs[:num_valid].long()
    z = loc[:, 0] - i * zl
    ok = (z >= 0) & (z < zl) & (loc[:, 0] >= 0)
    lloc = torch.stack([z, loc[:, 1], loc[:, 2], loc[:, 3]], -1)[ok]
    return scatter_sparse(lloc, feats[:num_valid][ok], lloc.shape[0],
                          (zl, Y, X), batch_size, cpad=cpad, dtype=dtype,
                          feat_bound=feat_bound, impl=impl)


def halo_exchange_z(fg: FGrid, group) -> FGrid:
    """Fill the z halo ring of a z-sharded FGrid from the neighbours'
    boundary interior planes (:1772-1791): ring plane 0 from the previous
    rank's plane Z, ring plane Z + 1 from the next rank's plane 1; the ranks
    at the ends keep their zero plane, the y and x rings stay zero, and a
    group of one returns the grid unchanged. Called at each 3^3 conv and
    upconv consumption site of the serving forward. The planes are
    written into the grid in place: its producer wrote a zero ring, and
    only the 3^3 sites, which need exactly these planes, read a ring."""
    if comm.size(group) == 1:
        return fg
    d = fg.data
    from_prev, from_next = comm.shift(d[:, -2], d[:, 1], group)
    d[:, 0] = from_prev
    d[:, -1] = from_next
    return fg


# ------------------------------------------------------------- grid algebra


def upsample2_folded(fg: FGrid) -> FGrid:
    """2x nearest-neighbour upsample (x slot s -> fine slots 2s, 2s+1)."""
    Z, Y, X = fg.dims
    s = fg.slots()[:, 1:Z + 1, 1:Y + 1]
    for ax in (1, 2, 3):
        s = s.repeat_interleave(2, dim=ax)
    xsf = _xq_for(2 * X, fg.cpad) * fg.fold
    return FGrid(_to_grid(_halo(s, xsf)), (2 * Z, 2 * Y, 2 * X), fg.real_c,
                 fg.cpad)


def repack_cpad(fg: FGrid, cpad_out: int) -> FGrid:
    """Re-fold to a wider per-voxel lane budget: pad each voxel's lanes
    to cpad_out and regroup the slots into 128-lane rows (real channels
    preserved, new lanes dead-zero)."""
    if cpad_out == fg.cpad:
        return fg
    if cpad_out != 2 * fg.cpad:
        raise ValueError(f"repack_cpad: {fg.cpad} -> {cpad_out}")
    xs_out = _xq_for(fg.dims[2], cpad_out) * (LANES // cpad_out)
    s = fg.slots()[:, :, :, :xs_out]
    s = nnf.pad(s, (0, cpad_out - fg.cpad, 0, xs_out - s.shape[3]))
    return FGrid(_to_grid(s), fg.dims, fg.real_c, cpad_out)


# ------------------------------------------------------------ batch norm


def bn_eval_constants(params: dict, stats: dict, c: int, off: int = 0,
                      eps: float = BN_EPS):
    """(mean, inv, bias) [c] f32 of an eval-mode BN channel slice, with
    inv = rsqrt(var + eps) * scale (ops/folded.py:bn_folded)."""
    sl = slice(off, off + c)
    inv = torch.rsqrt(_f32(stats["var"][sl]) + eps) * _f32(params["scale"][sl])
    return _f32(stats["mean"][sl]), inv, _f32(params["bias"][sl])


def _f32(a) -> torch.Tensor:
    """A float32 CPU copy of a numpy (or CPU tensor) parameter array."""
    return torch.tensor(np.asarray(a, np.float32))


def _lane_tile(vec: torch.Tensor, cpad: int) -> torch.Tensor:
    """[c] -> [128]: zero-padded to cpad, repeated over the F slots."""
    return nnf.pad(vec, (0, cpad - vec.shape[0])).repeat(LANES // cpad)


def bn_folded(fg: FGrid, fm: FGrid, mean: torch.Tensor, inv: torch.Tensor,
              bias: torch.Tensor) -> FGrid:
    """Eval-mode masked batch norm in folded layout: relu((x - mean) * inv
    + bias) rounded to the grid's type, times the mask."""
    cp = fg.cpad
    y = ((fg.data.float() - _lane_tile(mean, cp)) * _lane_tile(inv, cp)
         + _lane_tile(bias, cp)).clamp_min(0.0)
    return fg.with_data(y.to(fg.data.dtype) * fm.data)


def eval_affine(params: dict, stats: dict, c: int, off: int = 0,
                eps: float = BN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) [c] f32 of an eval BN as one affine x * scale + bias
    (ops/folded.py:_eval_affine), the form the fused kernels apply."""
    mean, inv, bias = bn_eval_constants(params, stats, c, off, eps)
    return inv, bias - mean * inv


# ---------------------------------------------- kernel-ready weight prep
#
# Every array is f32, zero-padded to MAXC channels, and its values are
# rounded to the compute type (what the TPU kernels' weight operands hold).


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.float().to(dtype).float()


def prep_conv_weights(w27, widths: list, dtype: torch.dtype) -> torch.Tensor:
    """[27, sum(widths), cout] -> [G, 27, 16, 16] per-group tap weights."""
    w = _f32(w27)
    if w.shape[0] != 27 or w.shape[1] != sum(widths):
        raise ValueError(f"conv weight {tuple(w.shape)} vs widths {widths}")
    out = torch.zeros(len(widths), 27, MAXC, MAXC)
    off = 0
    for g, c in enumerate(widths):
        out[g, :, :c, :w.shape[2]] = w[:, off:off + c]
        off += c
    return _rounded(out, dtype)


def prep_downconv_weights(w8, cin: int, dtype: torch.dtype) -> torch.Tensor:
    """[8, >= cin, cout] taps in (dz, dy, dx) order -> [8, 16, 16]."""
    w = _f32(w8)[:, :cin]
    out = torch.zeros(8, MAXC, MAXC)
    out[:, :cin, :w.shape[2]] = w
    return _rounded(out, dtype)


# per-axis tap membership: A[p, e, d + 1] = 1 iff original tap d of a fine
# voxel of parity p lands on coarse neighbour e (conv3d_folded.py:_UP_A)
_UP_A = np.array(
    [[[1, 0, 0], [0, 1, 1]],
     [[1, 1, 0], [0, 0, 1]]],
    np.float32,
)


def prep_upconv_weights(w27, widths: list, dtype: torch.dtype
                        ) -> torch.Tensor:
    """[27, sum(widths), cout] -> [G, 8 parity, 8 tap, 16, 16]: for fine
    parity (pz, py, px) and coarse neighbour (ez, ey, ex), the sum of the
    original taps landing there, summed in f32 and then rounded (as
    _fold_upsample_weights does; rounding each tap first would differ)."""
    w = _f32(w27)
    cout = w.shape[2]
    A = torch.as_tensor(_UP_A)
    out = torch.zeros(len(widths), 8, 8, MAXC, MAXC)
    off = 0
    for g, c in enumerate(widths):
        wg = w[:, off:off + c].reshape(3, 3, 3, c, cout)
        m = torch.einsum("azA,byB,cxC,ABCio->abczyxio", A, A, A, wg)
        out[g, :, :, :c, :cout] = m.reshape(8, 8, c, cout)
        off += c
    if off != w.shape[1]:
        raise ValueError(f"upconv weight {tuple(w.shape)} vs widths {widths}")
    return _rounded(out, dtype)


def prep_head_weights(W, widths: list, dtype: torch.dtype) -> torch.Tensor:
    """Linear [sum(widths), cout] -> [G, 16, 16] per-group row blocks."""
    w = _f32(W)
    out = torch.zeros(len(widths), MAXC, MAXC)
    off = 0
    for g, c in enumerate(widths):
        out[g, :c, :w.shape[1]] = w[off:off + c]
        off += c
    return _rounded(out, dtype)


def prep_bias(b) -> torch.Tensor:
    return nnf.pad(_f32(b), (0, MAXC - len(b)))


def prep_linear(W, dtype: torch.dtype) -> torch.Tensor:
    """A linear head [cin, cout] as f32 holding values rounded to dtype:
    the composed heads' operand (``linear_folded``)."""
    return _rounded(_f32(W), dtype)


def prep_affines(params: dict, stats: dict, widths: list) -> torch.Tensor:
    """Per-group eval-BN affines of a BN over concat(groups) -> [G, 2, 16]."""
    out = torch.zeros(len(widths), 2, MAXC)
    off = 0
    for g, c in enumerate(widths):
        a, b = eval_affine(params, stats, c, off)
        out[g, 0, :c], out[g, 1, :c] = a, b
        off += c
    return out


# --------------------------------------------------------- the fused sites


def subm_conv_fused(groups: list, fm: FGrid, w: torch.Tensor, cout: int, *,
                    aff: torch.Tensor | None = None,
                    residual: FGrid | None = None, quantize: bool = False,
                    ws: torch.Tensor | None = None,
                    impl: str | None = None) -> FGrid:
    """Conv site: [optional eval-BN + ReLU + mask] -> 3^3 conv over the
    groups -> mask [-> + residual] (kernel K1). ``quantize``: the int8
    mode, with ``w``/``ws`` from ``quant.quantize_conv_weights``."""
    g0 = groups[0]
    xs, cins = [g.data for g in groups], [g.real_c for g in groups]
    r = residual.data if residual is not None else None
    if quantize:
        out = K_conv.conv_site_q(xs, fm.data, w, ws, cins, g0.cpad, aff=aff,
                                 residual=r, impl=impl)
    else:
        out = K_conv.conv_site(xs, fm.data, w, cins, g0.cpad, aff=aff,
                               residual=r, impl=impl)
    return FGrid(out, g0.dims, cout, g0.cpad)


def downconv_fused(fg: FGrid, fm: FGrid, w: torch.Tensor, cout: int, *,
                   aff: torch.Tensor | None = None,
                   cpad_out: int | None = None, quantize: bool = False,
                   ws: torch.Tensor | None = None, impl: str | None = None
                   ) -> tuple[FGrid, FGrid]:
    """Stride-2 down site -> (coarse FGrid, coarse mask FGrid) (K2).
    ``quantize``: the int8 mode, with ``w``/``ws`` from
    ``quant.quantize_downconv_weights``."""
    co = cpad_out or fg.cpad
    if quantize:
        out, mout = K_down.downconv_q(fg.data, fm.data, w, ws, fg.real_c,
                                      fg.cpad, co, aff=aff, impl=impl)
    else:
        out, mout = K_down.downconv(fg.data, fm.data, w, fg.real_c, fg.cpad,
                                    co, aff=aff, impl=impl)
    Z, Y, X = fg.dims
    dims = (Z // 2, Y // 2, X // 2)
    return FGrid(out, dims, cout, co), FGrid(mout, dims, co, co)


def upconv_fused(groups: list, cfm: FGrid, ffm: FGrid | None,
                 w: torch.Tensor, cout: int, *,
                 aff: torch.Tensor | None = None, quantize: bool = False,
                 ws: torch.Tensor | None = None,
                 impl: str | None = None) -> FGrid:
    """Generative upsample site: [optional eval-BN + ReLU + coarse mask]
    -> 2x NN upsample -> 3^3 conv -> fine mask, from the coarse groups
    (K3). ``ffm=None`` expands the fine mask from ``cfm``. ``quantize``:
    the int8 mode, with ``w``/``ws`` from ``quant.quantize_upconv_weights``.
    """
    g0 = groups[0]
    Zc, Yc, Xc = g0.dims
    xqf = (_xq_for(2 * Xc, g0.cpad) if ffm is None
           else ffm.data.shape[3])
    xs, cins = [g.data for g in groups], [g.real_c for g in groups]
    f = ffm.data if ffm is not None else None
    if quantize:
        out = K_up.upconv_q(xs, cfm.data, f, w, ws, cins, g0.cpad, xqf,
                            aff=aff, impl=impl)
    else:
        out = K_up.upconv(xs, cfm.data, f, w, cins, g0.cpad, xqf, aff=aff,
                          impl=impl)
    return FGrid(out, (2 * Zc, 2 * Yc, 2 * Xc), cout, g0.cpad)


def head_site_fused(up: FGrid, fm: FGrid, w: torch.Tensor,
                    bias: torch.Tensor, aff: torch.Tensor, cout: int, *,
                    fm_scale: int = 1, emit_raw: bool = False,
                    impl: str | None = None) -> tuple:
    """Refinement tail: [eval-BN + ReLU + mask] -> occ|sdf heads ->
    occupancy gate -> (masked post-BN feats, masked heads, new mask) (K4
    gate mode), and with ``emit_raw`` the per-level raw f32 head grid
    (ring unspecified) as a fourth FGrid."""
    if fm.cpad != up.cpad:
        raise ValueError("head_site_fused: mask and grid lane budgets differ")
    outs = K_head.head_gate(up.data, fm.data, w, bias, aff, up.cpad,
                            mask_scale=fm_scale, emit_raw=emit_raw,
                            impl=impl)
    res = (up.with_data(outs[0]), FGrid(outs[1], up.dims, cout, up.cpad),
           FGrid(outs[2], up.dims, up.cpad, up.cpad))
    if emit_raw:
        res += (FGrid(outs[3], up.dims, cout, up.cpad),)
    return res


def surf_head_fused(groups: list, fm: FGrid, w: torch.Tensor,
                    bias: torch.Tensor, aff: torch.Tensor, *,
                    impl: str | None = None) -> FGrid:
    """Surface tail: per-group [eval-BN + ReLU + mask] -> summed linear ->
    raw f32 SDF grid (K4 summed mode)."""
    g0 = groups[0]
    out = K_head.head_sum([g.data for g in groups], fm.data, w, bias, aff,
                          [g.real_c for g in groups], g0.cpad, impl=impl)
    return FGrid(out, g0.dims, 1, g0.cpad)


def surf_head_packed(groups: list, fm: FGrid, w: torch.Tensor,
                     bias: torch.Tensor, aff: torch.Tensor, *,
                     impl: str | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale surface tail -> (sdf [B, Z, Y, X] f32, mask
    [B, Z, Y, X] bool) (K5).

    ``groups`` holds (FGrid, scale) pairs at their native resolutions
    (the deferred U-Net output; scale = NN-upsample factor to ``fm``'s
    resolution, 1 for the first). Per group: eval-BN + ReLU + head at
    native resolution; the NN expansion, sum, mask and bias happen per
    fine voxel, so the upsampled groups never exist. Matches
    [upsample2_folded* -> surf_head_fused -> unfold] (the summed form).
    """
    dims = fm.dims
    if groups[0][1] != 1:
        raise ValueError("surf_head_packed: the first group is at scale 1")
    for g, s in groups:
        if (g.cpad != fm.cpad or any(d % s for d in dims)
                or g.dims != tuple(d // s for d in dims)):
            raise ValueError(f"surf_head_packed: group {g.dims} at scale {s}"
                             f" (cpad {g.cpad}) does not fit {dims} (cpad "
                             f"{fm.cpad})")
    sdf = K_surf.surf_head(
        [g.data for g, _ in groups], [s for _, s in groups], fm.data, w,
        bias, aff, [g.real_c for g, _ in groups], fm.cpad, dims, impl=impl,
    )
    return sdf, unfold(fm)[..., 0] > 0.5


# ============================================================== training
#
# Port of sgnn_tpu/ops/folded.py:1135-1769. Parameters enter as the f32
# tensors of the JAX tree (weights [27 | 8, cin, cout], heads [cin, cout]);
# each Function pads and rounds them to the compute type in its forward,
# as ``w.astype(dt)`` does there, and returns their gradients in f32.
# BN moments and the affine built from them stay outside the Functions,
# so autograd produces the BN backward's moment terms, as in JAX. Clamps
# at zero are torch.relu, whose gradient at exactly 0 is 0 as that of
# jnp.maximum(x, 0) is (clamp_min's is 1): a dead channel's variance and
# an all-zero voxel's logit sit exactly there.


def _sv(t: torch.Tensor, cpad: int) -> torch.Tensor:
    """[B, Zp, Yp, xq, 128] -> slot view [B, Zp, Yp, xq * F, cpad]."""
    B, Zp, Yp, xq, _ = t.shape
    return t.view(B, Zp, Yp, xq * (LANES // cpad), cpad)


def _rehalo(t: torch.Tensor, xq: int) -> torch.Tensor:
    """[B, Z, Y, xb, 128] -> [B, Z+2, Y+2, xq, 128] with a zero ring."""
    return nnf.pad(t, (0, 0, 0, xq - t.shape[3], 1, 1, 1, 1))


def _pad_to(w: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``w`` zero-padded at the end of each dim to ``shape``, contiguous."""
    pad = []
    for have, want in zip(reversed(w.shape), reversed(shape)):
        pad += [0, want - have]
    return nnf.pad(w, pad).contiguous()


def _prep_taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[K, cin, cout] -> [K, 16, 16] f32 holding values rounded to dtype."""
    return _rounded(_pad_to(w.detach(), (w.shape[0], MAXC, MAXC)), dtype)


def _prep_aff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-channel affine vectors [cpad] -> [2, 16] f32."""
    return _pad_to(torch.stack([a.detach(), b.detach()]).float(), (2, MAXC))


# ------------------------------------------------- the 3^3 conv (K7)


def _conv_dx(g: torch.Tensor, w27: torch.Tensor, cpad: int, xq: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Input gradient of the folded 3^3 conv: K7 on the re-halo'd
    cotangent with flipped, in/out-transposed taps. Returns a halo'd grid
    whose ring is zero (conv_folded_train's note)."""
    K, cin, cout = w27.shape
    wt = torch.flip(w27.reshape(3, 3, 3, cin, cout), (0, 1, 2))
    wt = wt.reshape(27, cin, cout).transpose(1, 2)  # [27, cout, cin]
    dxi = K_raw.conv_raw(_rehalo(g.to(dtype), xq), _prep_taps(wt, dtype),
                         cout, cpad)
    return _rehalo(dxi, xq)


def _conv_dw(xf: torch.Tensor, g: torch.Tensor, w_shape: tuple,
             cpad: int) -> torch.Tensor:
    """Weight gradient [27, cin, cout] f32 of the folded 3^3 conv: per tap
    the reduce-GEMM of the shifted input slots with the cotangent slots,
    over every slot of every row (_conv_dw's 18 lane GEMMs and their
    slot-pattern adjoint, in the slot view: the same sums). ``xf``: the
    halo'd conv input; ``g``: the unpadded cotangent. Both are upcast, so
    bf16 products sum in f32 (cuDNN's weight gradient of the same conv was
    the slowest part of the step: PERF.md, PR 3)."""
    K, cin, cout = w_shape
    B, Z, Y, xq, _ = g.shape
    Xs = xq * (LANES // cpad)
    x = nnf.pad(_sv(xf, cpad)[..., :cin].float(), (0, 0, 1, 1))
    gs = g.view(B, Z, Y, Xs, cpad)[..., :cout].float().reshape(-1, cout)
    return torch.stack([
        x[:, dz:dz + Z, dy:dy + Y, dx:dx + Xs].reshape(-1, cin).T @ gs
        for dz in range(3) for dy in range(3) for dx in range(3)])


class _ConvTrain(torch.autograd.Function):
    """conv_folded_train (ops/folded.py:1164): halo'd xf -> unpadded f32
    [B, Z, Y, xq, 128]. The input gradient is zero on the halo ring."""

    @staticmethod
    def forward(ctx, xf, w27, cpad):
        ctx.save_for_backward(xf, w27)
        ctx.cpad = cpad
        # K7 with the taps rounded to xf's type, f32 out (_conv_train_impl)
        return K_raw.conv_raw(xf, _prep_taps(w27, xf.dtype), w27.shape[1],
                              cpad).float()

    @staticmethod
    def backward(ctx, g):
        xf, w27 = ctx.saved_tensors
        cpad, dt = ctx.cpad, xf.dtype
        g = g.to(dt)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv_dx(g, w27, cpad, xf.shape[3], dt)
        if ctx.needs_input_grad[1]:
            dw = _conv_dw(xf, g, tuple(w27.shape), cpad)
        return dx, dw, None


def conv_folded_train(xf: torch.Tensor, w27: torch.Tensor, cpad: int
                      ) -> torch.Tensor:
    return _ConvTrain.apply(xf, w27, cpad)


def subm_conv_folded_train(groups: list, fm: FGrid, w27: torch.Tensor,
                           cout: int) -> FGrid:
    """Training conv site: per-group conv_folded_train summed, re-halo'd,
    masked (ops/folded.py:1249)."""
    acc, off = None, 0
    for fg in groups:
        y = conv_folded_train(fg.data, w27[:, off:off + fg.real_c], fg.cpad)
        acc = y if acc is None else acc + y
        off += fg.real_c
    if off != w27.shape[1]:
        raise ValueError(f"conv weight {tuple(w27.shape)} vs groups {off}")
    g0 = groups[0]
    out = _rehalo(acc.to(g0.data.dtype), g0.data.shape[3]) * fm.data
    return FGrid(out, g0.dims, cout, g0.cpad)


# ------------------------------------------------------------ batch norm


def bn_moments(fg: FGrid, fm: FGrid, group=None):
    """Masked per-channel batch moments (f32, differentiable): (mean [C],
    biased var [C], count) in one pass, E[x^2] - E[x]^2 (_bn_moments).
    With ``group`` the sums and the count are summed over its ranks first,
    in one all-reduce (the psum of :579-582: BN over the global batch)."""
    cpad, C = fg.cpad, fg.real_c
    xf = fg.data.float() * fm.data.float()
    s = _sv(xf, cpad).sum((0, 1, 2, 3))
    sq = _sv(xf * xf, cpad).sum((0, 1, 2, 3))
    cnt, s, sq = comm.all_reduce_each([fm.data.float().sum() / cpad, s, sq],
                                      group)
    cnt = cnt.clamp_min(1.0)
    mean = (s / cnt)[:C]
    var = torch.relu((sq / cnt)[:C] - mean * mean)
    return mean, var, cnt


def bn_stats_update(stats: dict, mean, var, cnt) -> dict:
    """Running stats: unbiased variance, retain factor BN_MOMENTUM;
    detached (the caller stores them after the step)."""
    m = BN_MOMENTUM
    unbiased = var * (cnt / (cnt - 1.0).clamp_min(1.0))
    return {"mean": (m * stats["mean"] + (1 - m) * mean).detach(),
            "var": (m * stats["var"] + (1 - m) * unbiased).detach()}


def _vec(v: torch.Tensor, cpad: int) -> torch.Tensor:
    return nnf.pad(v.float(), (0, cpad - v.shape[0]))


def bn_folded_train(params: dict, stats: dict, fg: FGrid, fm: FGrid, *,
                    training: bool, group=None):
    """Masked BN + ReLU in folded layout (bn_folded:599): batch moments
    (over ``group``'s ranks) when training, with the updated running
    stats; running stats else."""
    C, cpad = fg.real_c, fg.cpad
    if training:
        mean, var, cnt = bn_moments(fg, fm, group)
        new_stats = bn_stats_update(stats, mean, var, cnt)
    else:
        mean, var, new_stats = stats["mean"][:C], stats["var"][:C], stats
    inv = torch.rsqrt(var + BN_EPS) * params["scale"][:C]
    y = torch.relu((_sv(fg.data, cpad).float() - _vec(mean, cpad))
                   * _vec(inv, cpad) + _vec(params["bias"][:C], cpad))
    out = y.to(fg.data.dtype).view(fg.data.shape) * fm.data
    return fg.with_data(out), new_stats


def train_affine(params: dict, stats: dict, fg: FGrid, fm: FGrid, *,
                 off: int = 0, group=None):
    """One group's batch-stats BN as an affine (a, b [cpad] f32) and its
    new running stats (_train_affine:1430), the moments over ``group``'s
    ranks."""
    c, cpad = fg.real_c, fg.cpad
    scale, bias = params["scale"][off:off + c], params["bias"][off:off + c]
    st = {k: stats[k][off:off + c] for k in ("mean", "var")}
    mean, var, cnt = bn_moments(fg, fm, group)
    ns = bn_stats_update(st, mean, var, cnt)
    inv = torch.rsqrt(var + BN_EPS) * scale
    return _vec(inv, cpad), _vec(bias - mean * inv, cpad), ns


def cat_stats(parts: list) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in ("mean", "var")}


def _affine_relu(x: torch.Tensor, m: torch.Tensor, a, b, cpad: int
                 ) -> torch.Tensor:
    """round(relu(x * a + b)) * m on a halo'd grid (a, b per channel)."""
    u = torch.relu(_sv(x, cpad).float() * a + b)
    return u.to(x.dtype).view(x.shape) * m


# ------------------------------------------- fused BN -> conv (K1 + K7)


class _BnConvCore(torch.autograd.Function):
    """_bnconv_core (ops/folded.py:1300): relu(x_g * a_g + b_g) * m ->
    sum_g conv3 -> * m, halo'd. Forward K1; backward by hand, the input
    gradient of each group through K7."""

    @staticmethod
    def forward(ctx, cpad, cout, m, *arrs):
        G = len(arrs) // 4
        xs, a_s, b_s, ws = (arrs[i * G:(i + 1) * G] for i in range(4))
        ctx.save_for_backward(m, *arrs)
        ctx.cpad, ctx.G = cpad, G
        dt = xs[0].dtype
        w = torch.stack([_prep_taps(wg, dt) for wg in ws])
        aff = torch.stack([_prep_aff(a, b) for a, b in zip(a_s, b_s)])
        return K_conv.conv_site(list(xs), m, w, [wg.shape[1] for wg in ws],
                                cpad, aff=aff)

    @staticmethod
    def backward(ctx, g):
        m, *arrs = ctx.saved_tensors
        cpad, G = ctx.cpad, ctx.G
        xs, a_s, b_s, ws = (arrs[i * G:(i + 1) * G] for i in range(4))
        dt, xq = xs[0].dtype, xs[0].shape[3]
        # adjoint of out = rehalo(acc) * m: m's ring is zero, so the
        # interior of g * m is the cotangent of the conv sums
        d_acc = (g * m).to(dt)[:, 1:-1, 1:-1]
        mf = _sv(m, cpad).float()
        dxs, das, dbs, dws = [], [], [], []
        for x, a, b, w in zip(xs, a_s, b_s, ws):
            xv = _sv(x, cpad).float()
            pre = xv * a + b
            gate = torch.where(pre > 0, mf, torch.zeros_like(mf))
            u = _affine_relu(x, m, a, b, cpad)
            g_u = _sv(_conv_dx(d_acc, w, cpad, xq, dt), cpad).float()
            g_pre = g_u * gate
            dxs.append((g_pre * a).to(dt).view(x.shape))
            das.append((g_pre * xv).sum((0, 1, 2, 3)))
            dbs.append(g_pre.sum((0, 1, 2, 3)))
            dws.append(_conv_dw(u, d_acc, tuple(w.shape), cpad))
        # the mask comes from comparisons: no gradient (as in JAX)
        return (None, None, None, *dxs, *das, *dbs, *dws)


def bn_conv_folded_train(bn_params: dict, bn_stats: dict, groups: list,
                         fm: FGrid, w27: torch.Tensor, cout: int, *,
                         group=None):
    """Fused BN(+ReLU) -> 3^3 conv site (bn_conv_folded_train:1341):
    (FGrid, new stats)."""
    g0 = groups[0]
    a_s, b_s, ws, parts, off = [], [], [], [], 0
    for fg in groups:
        a, b, ns = train_affine(bn_params, bn_stats, fg, fm, off=off,
                                group=group)
        a_s.append(a)
        b_s.append(b)
        parts.append(ns)
        ws.append(w27[:, off:off + fg.real_c])
        off += fg.real_c
    if off != w27.shape[1]:
        raise ValueError(f"conv weight {tuple(w27.shape)} vs groups {off}")
    out = _BnConvCore.apply(g0.cpad, cout, fm.data,
                            *[g.data for g in groups], *a_s, *b_s, *ws)
    return FGrid(out, g0.dims, cout, g0.cpad), cat_stats(parts)


# --------------------------- the other sites: kernel forward, composed VJP


class _Site(torch.autograd.Function):
    """_site_train_core (ops/folded.py:1404): ``kernel_fn`` forward (the
    serving kernel), backward by autograd through ``plain_fn``, the
    unfused composition, recomputed at the saved inputs. ``masks``: the
    indices of outputs that are masks (no gradient)."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, masks, *arrs):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*arrs)
        outs = kernel_fn(*arrs)
        ctx.mark_non_differentiable(*[outs[i] for i in masks])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        arrs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(n) for a, n in zip(arrs, need)]
            outs = ctx.plain_fn(*ins)
            pairs = [(o, g) for o, g in zip(outs, gs) if o.requires_grad]
            want = [i for i in ins if i.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True))
        return (None, None, None,
                *[next(got) if i.requires_grad else None for i in ins])


def _site(kernel_fn, plain_fn, masks: tuple, *arrs):
    return _Site.apply(kernel_fn, plain_fn, masks, *arrs)


def _strided_sum(xs: list, cins: list, w8: torch.Tensor, cpad: int
                 ) -> torch.Tensor:
    """The stride-2 2^3 conv of halo'd grids ``xs`` (the groups of an
    input of widths ``cins``; w8 [8, sum(cins), cout] in (dz, dy, dx)
    order, rounded to their type): each group's products in one f32
    matmul, the groups summed in f32 -> [B, Zc, Yc, Xh, cout] f32, Xh half
    the fine slots."""
    acc, off = None, 0
    for u, cin in zip(xs, cins):
        B, Zp, Yp, xq, _ = u.shape
        Zc, Yc, Xh = (Zp - 2) // 2, (Yp - 2) // 2, xq * (LANES // cpad) // 2
        t = _sv(u, cpad)[:, 1:-1, 1:-1, :, :cin].float()
        t = t.reshape(B, Zc, 2, Yc, 2, Xh, 2, cin).permute(
            0, 1, 3, 5, 2, 4, 6, 7)
        y = t.reshape(B, Zc, Yc, Xh, 8 * cin) @ _rounded(
            w8[:, off:off + cin], u.dtype).reshape(8 * cin, -1)
        acc = y if acc is None else acc + y
        off += cin
    if off != w8.shape[1]:
        raise ValueError(f"stride-2 weight {tuple(w8.shape)} vs groups {off}")
    return acc


def _mask_down(m: torch.Tensor, cpad: int) -> torch.Tensor:
    """maxpool2 of a halo'd 0/1 mask grid -> [B, Zc, Yc, Xh, 1] f32."""
    mf = _sv(m, cpad)[:, 1:-1, 1:-1, :, 0].float()
    return nnf.max_pool3d(mf[:, None], 2)[:, 0][..., None]


def _coarse_grid(t: torch.Tensor, cpad: int, xq: int) -> torch.Tensor:
    """Coarse slots [B, Zc, Yc, n, c <= cpad] -> a halo'd grid at lane
    budget ``cpad`` with ``xq`` x blocks (slots cropped or zero-padded)."""
    B, Zc, Yc, n, _ = t.shape
    xs = xq * (LANES // cpad)
    n = min(n, xs)
    t = _pad_to(t[:, :, :, :n], (B, Zc, Yc, n, cpad))
    return nnf.pad(t, (0, 0, 0, xs - n, 1, 1, 1, 1)).reshape(
        B, Zc + 2, Yc + 2, xq, LANES)


def _strided_plain(xs: list, m: torch.Tensor, w8: torch.Tensor, cins: list,
                   cpad: int, cpad_out: int, xqc: int):
    """The stride-2 2^3 conv of halo'd groups and maxpool2 of their mask,
    composed (strided_conv_folded:423 + mask_down_folded:463, and with
    cpad_out = 2 * cpad the cross site, folded_train.py:104): f32 sums
    rounded to the groups' type, times the coarse mask; (coarse grid,
    coarse mask) halo'd at cpad_out with xqc x blocks."""
    dt = xs[0].dtype
    y = _strided_sum(xs, cins, w8, cpad)
    mc = _mask_down(m, cpad)
    return (_coarse_grid((y * mc).to(dt), cpad_out, xqc),
            _coarse_grid(mc.expand(*mc.shape[:4], cpad_out).to(dt),
                         cpad_out, xqc))


def downconv_folded_train(fg: FGrid, fm: FGrid, w8: torch.Tensor, cout: int,
                          *, affine: tuple | None = None,
                          cpad_out: int | None = None):
    """Stride-2 down site (downconv_folded_train:1497): [affine + ReLU +
    fine mask] -> 2^3 stride-2 conv -> coarse mask; K2 forward."""
    cpad, cin = fg.cpad, fg.real_c
    co = cpad_out or cpad
    xqc = K_down.coarse_xq(fg.data.shape[3], cpad, co)
    has_aff = affine is not None
    w8 = w8[:, :cin]

    def split(arrs):
        return arrs if has_aff else (arrs[0], arrs[1], None, None, arrs[2])

    def kernel_fn(*arrs):
        x, m, a, b, w = split(arrs)
        aff = _prep_aff(a, b) if has_aff else None
        return K_down.downconv(x, m, _prep_taps(w, x.dtype), cin, cpad, co,
                               aff=aff)

    def plain_fn(*arrs):
        x, m, a, b, w = split(arrs)
        u = _affine_relu(x, m, a, b, cpad) if has_aff else x
        return _strided_plain([u], m, w, [cin], cpad, co, xqc)

    arrs = (fg.data, fm.data, *(affine if has_aff else ()), w8)
    out, mout = _site(kernel_fn, plain_fn, (1,), *arrs)
    dims = tuple(d // 2 for d in fg.dims)
    return FGrid(out, dims, cout, co), FGrid(mout, dims, co, co)


def bn_downconv_folded_train(bn_params: dict, bn_stats: dict, fg: FGrid,
                             fm: FGrid, w8: torch.Tensor, cout: int, *,
                             cpad_out: int | None = None, group=None):
    """BN + ReLU -> stride-2 conv -> coarse mask (:1551)."""
    a, b, ns = train_affine(bn_params, bn_stats, fg, fm, group=group)
    down, down_fm = downconv_folded_train(fg, fm, w8, cout, affine=(a, b),
                                          cpad_out=cpad_out)
    return down, down_fm, ns


def bn_upconv_folded_train(bn_params: dict, bn_stats: dict, groups: list,
                           cfm: FGrid, ffm: FGrid, w27: torch.Tensor,
                           cout: int, *, group=None):
    """Generative upsample site (bn_upconv_folded_train:1566): per group
    [BN + ReLU + coarse mask] -> 2x NN upsample -> 3^3 conv -> fine mask.
    K3 forward; the composition's backward runs K7 (its conv is
    subm_conv_folded_train)."""
    g0 = groups[0]
    cpad, dims_c = g0.cpad, g0.dims
    cins = [g.real_c for g in groups]
    G = len(groups)
    a_s, b_s, parts, off = [], [], [], 0
    for g in groups:
        a, b, ns = train_affine(bn_params, bn_stats, g, cfm, off=off,
                                group=group)
        a_s.append(a)
        b_s.append(b)
        parts.append(ns)
        off += g.real_c
    if off != w27.shape[1]:
        raise ValueError(f"upconv weight {tuple(w27.shape)} vs groups {off}")
    xqf = ffm.data.shape[3]

    def unpack(arrs):
        return (arrs[:G], arrs[G], arrs[G + 1], arrs[G + 2:2 * G + 2],
                arrs[2 * G + 2:3 * G + 2], arrs[-1])

    def kernel_fn(*arrs):
        xs, cm, fmf, a_, b_, w = unpack(arrs)
        wp = _upconv_taps(w, cins, xs[0].dtype)
        aff = torch.stack([_prep_aff(a, b) for a, b in zip(a_, b_)])
        return (K_up.upconv(list(xs), cm, fmf, wp, cins, cpad, xqf,
                            aff=aff),)

    def plain_fn(*arrs):
        xs, cm, fmf, a_, b_, w = unpack(arrs)
        ups = [upsample2_folded(FGrid(_affine_relu(x, cm, a, b, cpad),
                                      dims_c, c, cpad))
               for x, a, b, c in zip(xs, a_, b_, cins)]
        fmg = FGrid(fmf, tuple(2 * d for d in dims_c), cpad, cpad)
        return (subm_conv_folded_train(ups, fmg, w, cout).data,)

    out = _site(kernel_fn, plain_fn, (), *[g.data for g in groups], cfm.data,
                ffm.data, *a_s, *b_s, w27)
    return (FGrid(out[0], tuple(2 * d for d in dims_c), cout, cpad),
            cat_stats(parts))


def _upconv_taps(w27: torch.Tensor, widths: list, dtype: torch.dtype
                 ) -> torch.Tensor:
    """prep_upconv_weights on a tensor: [G, 8, 8, 16, 16] per-parity
    combined taps, summed in f32, then rounded."""
    w = w27.detach().float()
    cout = w.shape[2]
    A = torch.as_tensor(_UP_A, device=w.device)
    out = w.new_zeros(len(widths), 8, 8, MAXC, MAXC)
    off = 0
    for g, c in enumerate(widths):
        wg = w[:, off:off + c].reshape(3, 3, 3, c, cout)
        m = torch.einsum("azA,byB,cxC,ABCio->abczyxio", A, A, A, wg)
        out[g, :, :, :c, :cout] = m.reshape(8, 8, c, cout)
        off += c
    return _rounded(out, dtype)


def _linear_plain(u: torch.Tensor, W: torch.Tensor, cpad: int):
    """Per-voxel channel mix (linear_folded:511) of a halo'd grid, the
    weight rounded to u's type: f32 slot view [.., Xs, cpad]."""
    Wp = _pad_to(_rounded(W, u.dtype), (cpad, cpad))
    return _sv(u, cpad).float() @ Wp


def bn_head_site_folded_train(bn_params: dict, bn_stats: dict, up: FGrid,
                              fm: FGrid, W2: torch.Tensor, b2: torch.Tensor,
                              *, group=None):
    """Refinement tail (bn_head_site_folded_train:1636): [n2 BN + ReLU +
    mask] -> occ|sdf heads -> gate -> (masked feats, masked heads, new
    mask, raw f32 heads, new stats). K4 gate mode with the raw output."""
    cpad, dims, cin = up.cpad, up.dims, up.real_c
    cout = W2.shape[1]
    a, b, ns = train_affine(bn_params, bn_stats, up, fm, group=group)

    def kernel_fn(x, m, a, b, W, bv):
        return K_head.head_gate(
            x, m, _pad_to(_rounded(W.detach(), x.dtype), (MAXC, MAXC)),
            _pad_to(bv.detach().float(), (MAXC,)), _prep_aff(a, b), cpad,
            mask_scale=1, emit_raw=True)

    def plain_fn(x, m, a, b, W, bv):
        dt = x.dtype
        u = _affine_relu(x, m, a, b, cpad)
        out2 = _linear_plain(u, W, cpad) + _vec(bv, cpad)
        occ = (out2[..., :1] > 0).to(dt).expand(out2.shape)
        nf = occ.reshape(x.shape) * m
        out2 = out2.view(x.shape)
        return u * nf, out2.to(dt) * nf, nf, out2

    upm, o2m, fmn, raw = _site(kernel_fn, plain_fn, (2,), up.data, fm.data,
                               a, b, W2, b2)
    return (FGrid(upm, dims, cin, cpad), FGrid(o2m, dims, cout, cpad),
            FGrid(fmn, dims, cpad, cpad), FGrid(raw, dims, cout, cpad), ns)


def bn_surf_head_folded_train(bn_params: dict, bn_stats: dict, groups: list,
                              fm: FGrid, W: torch.Tensor, bias: torch.Tensor,
                              *, group=None):
    """Surface tail (bn_surf_head_folded_train:1691): per group [p3 BN +
    ReLU + mask] -> summed linear + bias -> raw f32 SDF grid. K4 summed
    mode forward."""
    g0 = groups[0]
    cpad, dims = g0.cpad, g0.dims
    cins = [g.real_c for g in groups]
    G = len(groups)
    a_s, b_s, parts, off = [], [], [], 0
    for g in groups:
        a, b, ns = train_affine(bn_params, bn_stats, g, fm, off=off,
                                group=group)
        a_s.append(a)
        b_s.append(b)
        parts.append(ns)
        off += g.real_c
    if off != W.shape[0]:
        raise ValueError(f"surface head {tuple(W.shape)} vs groups {off}")

    def unpack(arrs):
        return (arrs[:G], arrs[G], arrs[G + 1:2 * G + 1],
                arrs[2 * G + 1:3 * G + 1], arrs[-2], arrs[-1])

    def kernel_fn(*arrs):
        xs, m, a_, b_, W_, bv = unpack(arrs)
        dt = xs[0].dtype
        tiles, o = [], 0
        for c in cins:
            tiles.append(_pad_to(_rounded(W_[o:o + c].detach(), dt),
                                 (MAXC, MAXC)))
            o += c
        aff = torch.stack([_prep_aff(a, b) for a, b in zip(a_, b_)])
        return (K_head.head_sum(list(xs), m, torch.stack(tiles),
                                _pad_to(bv.detach().float(), (MAXC,)), aff,
                                cins, cpad),)

    def plain_fn(*arrs):
        xs, m, a_, b_, W_, bv = unpack(arrs)
        acc, o = None, 0
        for x, a, b, c in zip(xs, a_, b_, cins):
            y = _linear_plain(_affine_relu(x, m, a, b, cpad), W_[o:o + c],
                              cpad)
            acc = y if acc is None else acc + y
            o += c
        return ((acc + _vec(bv, cpad)).view(m.shape),)

    out = _site(kernel_fn, plain_fn, (), *[g.data for g in groups], fm.data,
                *a_s, *b_s, W, bias)
    return FGrid(out[0], dims, 1, cpad), cat_stats(parts)


# ------------------------------------------- the composed BN -> op forms
#
# Port of the lane-GEMM helpers the JAX package composes outside any Pallas
# kernel (ops/folded.py:419-565, 826-863; models/folded_train.py:98-144):
# the training forward's composed branch (fuse_train_bn off, or
# training=False) and the serving forward's SGNN_NO_UPCONV / NO_HEADK
# branches run them. Plain differentiable tensor ops on the slot view.
# Masks are 0/1 comparisons, bit-equal to JAX's GEMM-and-clamp. Where JAX
# sums the four (dz, dy) partial GEMMs of a stride-2 conv in f32, this sums
# each group's 8 taps in one f32 matmul (then the groups in order): another
# f32 order, within 1e-5 of JAX's in f32 and 2 ulps in bf16 after the one
# rounding both make.


def mask_and(a: FGrid, b: FGrid) -> FGrid:
    return a.with_data(a.data * b.data)


def strided_conv_folded(groups: list, w8: torch.Tensor, cout: int) -> FGrid:
    """Stride-2 2^3 conv of grouped FGrids, summed over the groups in f32
    and rounded to their type -> coarse FGrid, unmasked (:423)."""
    g0 = groups[0]
    dims = tuple(d // 2 for d in g0.dims)
    y = _strided_sum([g.data for g in groups], [g.real_c for g in groups],
                     w8, g0.cpad)
    return FGrid(_coarse_grid(y.to(g0.data.dtype), g0.cpad,
                              _xq_for(dims[2], g0.cpad)), dims, cout, g0.cpad)


def mask_down_folded(fm: FGrid) -> FGrid:
    """maxpool2 of a 0/1 mask FGrid: a parent is active when a child is
    (:463)."""
    dims = tuple(d // 2 for d in fm.dims)
    mc = _mask_down(fm.data, fm.cpad)
    m = mc.expand(*mc.shape[:4], fm.cpad).to(fm.data.dtype)
    return FGrid(_coarse_grid(m, fm.cpad, _xq_for(dims[2], fm.cpad)), dims,
                 fm.cpad, fm.cpad)


def strided_site_folded(groups: list, fm: FGrid, w8: torch.Tensor,
                        cout: int, cpad_out: int | None = None
                        ) -> tuple[FGrid, FGrid]:
    """The composed stride-2 site: strided conv times the maxpool2 mask ->
    (coarse FGrid, coarse mask) (folded_train.py:_strided_site_f:98); with
    ``cpad_out`` = 2 * cpad the cross site, which widens the lane budget
    across the stride (_strided_site_cross_f:104)."""
    g0 = groups[0]
    co = cpad_out or g0.cpad
    if co not in (g0.cpad, 2 * g0.cpad):
        raise ValueError(f"strided site: cpad {g0.cpad} -> {co}")
    dims = tuple(d // 2 for d in g0.dims)
    out, mout = _strided_plain([g.data for g in groups], fm.data, w8,
                               [g.real_c for g in groups], g0.cpad, co,
                               _xq_for(dims[2], co))
    return FGrid(out, dims, cout, co), FGrid(mout, dims, co, co)


def linear_folded(fg: FGrid, W: torch.Tensor, b: torch.Tensor | None = None,
                  out_dtype: torch.dtype = torch.float32) -> FGrid:
    """Per-voxel channel mix W [real_c, cout] (rounded to the grid's type,
    f32 sums) -> FGrid of ``out_dtype``; the bias lands on every voxel slot,
    the ring and the x tail too, so the caller masks the result (:511)."""
    y = _linear_plain(fg.data, W, fg.cpad).to(out_dtype)
    if b is not None:
        y = y + _vec(b, fg.cpad).to(out_dtype)
    return FGrid(y.reshape(fg.data.shape), fg.dims, W.shape[1], fg.cpad)


def linear_sum_folded(groups: list, W: torch.Tensor, bias: torch.Tensor
                      ) -> FGrid:
    """Each group's rows of W [sum(widths), cout] as a linear_folded, summed
    in f32 in group order, plus the bias on every voxel slot: the composed
    surface head (folded_train.py:376-391, folded_flow.py:336-350)."""
    acc, off = None, 0
    for g in groups:
        y = _linear_plain(g.data, W[off:off + g.real_c], g.cpad)
        acc = y if acc is None else acc + y
        off += g.real_c
    if off != W.shape[0]:
        raise ValueError(f"linear {tuple(W.shape)} vs groups {off}")
    g0 = groups[0]
    return FGrid((acc + _vec(bias, g0.cpad)).view(g0.data.shape), g0.dims,
                 W.shape[1], g0.cpad)


def occ_mask_folded(out: FGrid, dtype: torch.dtype = torch.bfloat16
                    ) -> FGrid:
    """occ logit (channel 0) > 0, strictly, as a 0/1 mask FGrid of
    ``dtype`` (:554): sigmoid(x) > 0.5, and a zero logit stays inactive."""
    s = _sv(out.data, out.cpad)
    m = (s[..., :1] > 0).to(dtype).expand(s.shape)
    return FGrid(m.reshape(out.data.shape), out.dims, out.cpad, out.cpad)


def head_gate_composed(up: FGrid, fm: FGrid, W2: torch.Tensor,
                       b2: torch.Tensor) -> tuple:
    """The composed refinement tail after its n2 BN (folded_train.py:
    320-327, folded_flow.py:277-282): the occ|sdf heads in f32, the
    occupancy gate times the unfiltered fine mask ``fm`` -> (masked feats,
    masked heads in the grid's type, new mask, raw f32 heads)."""
    dt = up.data.dtype
    out2 = linear_folded(up, W2, b2)
    new_fm = mask_and(occ_mask_folded(out2, dt), fm)
    return (mask_and(up, new_fm),
            out2.with_data(out2.data.to(dt) * new_fm.data), new_fm, out2)
