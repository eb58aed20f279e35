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
multi-scale surface head) run
the CUDA kernels of ``ops/kernels``, or their plain versions on the CPU.
The sites take kernel-ready weights prepared once by the ``prep_*``
functions below (the port's replacement for the JAX package's
record/replay weight stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from sgnn_tpu_torch.ops.kernels import conv_site as K_conv
from sgnn_tpu_torch.ops.kernels import downconv as K_down
from sgnn_tpu_torch.ops.kernels import head as K_head
from sgnn_tpu_torch.ops.kernels import scatter as K_scatter
from sgnn_tpu_torch.ops.kernels import surf_head as K_surf
from sgnn_tpu_torch.ops.kernels import upconv as K_up

LANES = 128
MAXC = 16  # channel padding of every prepared weight/affine array
BN_EPS = 1e-4  # scn's BatchNormReLU eps (not torch's 1e-5)


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
                    residual: FGrid | None = None,
                    impl: str | None = None) -> FGrid:
    """Conv site: [optional eval-BN + ReLU + mask] -> 3^3 conv over the
    groups -> mask [-> + residual] (kernel K1)."""
    g0 = groups[0]
    out = K_conv.conv_site(
        [g.data for g in groups], fm.data, w, [g.real_c for g in groups],
        g0.cpad, aff=aff,
        residual=residual.data if residual is not None else None, impl=impl,
    )
    return FGrid(out, g0.dims, cout, g0.cpad)


def downconv_fused(fg: FGrid, fm: FGrid, w: torch.Tensor, cout: int, *,
                   aff: torch.Tensor | None = None,
                   cpad_out: int | None = None, impl: str | None = None
                   ) -> tuple[FGrid, FGrid]:
    """Stride-2 down site -> (coarse FGrid, coarse mask FGrid) (K2)."""
    co = cpad_out or fg.cpad
    out, mout = K_down.downconv(fg.data, fm.data, w, fg.real_c, fg.cpad, co,
                                aff=aff, impl=impl)
    Z, Y, X = fg.dims
    dims = (Z // 2, Y // 2, X // 2)
    return FGrid(out, dims, cout, co), FGrid(mout, dims, co, co)


def upconv_fused(groups: list, cfm: FGrid, ffm: FGrid | None,
                 w: torch.Tensor, cout: int, *,
                 aff: torch.Tensor | None = None,
                 impl: str | None = None) -> FGrid:
    """Generative upsample site: [optional eval-BN + ReLU + coarse mask]
    -> 2x NN upsample -> 3^3 conv -> fine mask, from the coarse groups
    (K3). ``ffm=None`` expands the fine mask from ``cfm``."""
    g0 = groups[0]
    Zc, Yc, Xc = g0.dims
    xqf = (_xq_for(2 * Xc, g0.cpad) if ffm is None
           else ffm.data.shape[3])
    out = K_up.upconv(
        [g.data for g in groups], cfm.data,
        ffm.data if ffm is not None else None, w,
        [g.real_c for g in groups], g0.cpad, xqf, aff=aff, impl=impl,
    )
    return FGrid(out, (2 * Zc, 2 * Yc, 2 * Xc), cout, g0.cpad)


def head_site_fused(up: FGrid, fm: FGrid, w: torch.Tensor,
                    bias: torch.Tensor, aff: torch.Tensor, cout: int, *,
                    fm_scale: int = 1, impl: str | None = None
                    ) -> tuple[FGrid, FGrid, FGrid]:
    """Refinement tail: [eval-BN + ReLU + mask] -> occ|sdf heads ->
    occupancy gate -> (masked post-BN feats, masked heads, new mask) (K4
    gate mode; the per-level raw head grid is not produced)."""
    if fm.cpad != up.cpad:
        raise ValueError("head_site_fused: mask and grid lane budgets differ")
    upm, o2m, fmn = K_head.head_gate(up.data, fm.data, w, bias, aff,
                                     up.cpad, mask_scale=fm_scale, impl=impl)
    return (up.with_data(upm), FGrid(o2m, up.dims, cout, up.cpad),
            FGrid(fmn, up.dims, up.cpad, up.cpad))


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
