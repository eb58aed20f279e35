"""K10: the fused neighbour gather and tap GEMM of the coordinate-list
sparse conv (csrc/gather_gemm.cu), forward and input gradient.

Port of sgnn_tpu/ops/pallas/gather_gemm.py ``gather_gemm_pallas`` (:62),
with its contract ``(feats, nbr_rows, weight)``:

    out[n] = round(sum_k feats[nbr_rows[n, k] - 1] @ W[k])    f32 sums

``feats [cap, Cin]`` in the compute type, ``nbr_rows [cap, K]`` int32
row + 1 (0 = missing), ``weight [K, Cin, Cout]`` rounded to feats' type;
the output ``[cap, Cout]`` is in feats' type, rounded once. On the card
every call launches the kernel: the JAX package's gate (the
``SGNN_TPU_PALLAS_GATHER`` flag and the 12 MB VMEM table limit) was a
Mosaic workaround. The plain version is the tap-grouped form of
sgnn_tpu/ops/conv.py ``gather_gemm`` (:101-111), differentiable by torch
autograd (the gather's backward an index_add).

Under autograd the card's call is a ``torch.autograd.Function``. The input
gradient is itself a gather-GEMM, over the inverse neighbour list
(``inverse_rows``): dX[m] = sum_k W[k] g[inv[m, k] - 1], one more K10 launch
(``gather_gemm_dx``) with the per-tap transposed weights [K, Cout, Cin];
each input row is summed by one warp in a fixed order, so it gives the same
bits on every run (CUDA's ``index_add_`` sums with atomics). The weight
gradient, per tap group ``gathered^T @ g`` summed in f32, stays a matmul,
as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

launches = 0  # forward launches since the last reset_launch_counts()
dx_launches = 0  # input-gradient launches (gather_gemm_dx) since then

# csrc/gather_gemm.cu's tiling: output rows a warp, warps a block, a warp's
# ring of staged units, output columns a block, most input channels a
# staged unit, and the shared memory a block may take
_SLICE, _WARPS, _STAGES, _COLS, _CCH = 16, 8, 4, 16, 64
_SMEM_MAX = 227 * 1024


def chunking(cout: int) -> tuple[int, int]:
    """(CO, coutp): the kernels' output chunk width and the padded width
    of their prepared weights (csrc/common.cuh, row kernels)."""
    co = 4 if cout <= 4 else 8 if cout <= 8 else 16
    return co, -(-cout // co) * co


def prep_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[taps, Cin, Cout] -> f32 [taps, Cin, coutp]: values rounded to
    ``dtype``, zero columns beyond Cout, contiguous."""
    _, coutp = chunking(weight.shape[-1])
    w = weight.to(dtype).float()
    return F.pad(w, (0, coutp - w.shape[-1])).contiguous()


def vec_rows(t: torch.Tensor, width: int) -> int:
    """1 when rows of ``width`` values of ``t`` can be read as 16-byte
    vectors."""
    return int(width * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0)


def fits(num_taps: int, cin: int, dtype: torch.dtype) -> bool:
    """Whether K10 takes ``num_taps`` taps of ``cin`` input channels in
    ``dtype``: its fixed shared memory and one unit's weights must fit a
    block (csrc/gather_gemm.cu, ``launch_gather_gemm``; the kernel refuses
    the launch otherwise). Output widths are not limited: column groups of
    16 run on ``blockIdx.y``."""
    sz = 2 if dtype == torch.bfloat16 else 4
    ciu, ncc = min(cin, _CCH), -(-cin // _CCH)
    vec = 16 if sz == 2 else 4  # bf16: MMA k-steps; f32: float4 rows
    cinp = -(-ciu // vec) * vec
    words = cinp * sz // 16
    words += words % 2 == 0
    up16 = lambda b: -(-b // 16) * 16  # noqa: E731
    fixed = _WARPS * (up16(4 * _SLICE * num_taps) + up16(4 * num_taps * ncc)
                      + _STAGES * _SLICE * words * 16)
    unit_w = 512 * (cinp // 16) if sz == 2 else 4 * ciu * _COLS
    return fixed + unit_w <= _SMEM_MAX


def _tap_groups(num_taps: int, cin: int, target_k: int = 128) -> list:
    """Taps in groups of ~target_k / cin: [(start, size)]."""
    g = max(1, min(num_taps, target_k // max(cin, 1)))
    return [(s, min(g, num_taps - s)) for s in range(0, num_taps, g)]


def gather_gemm(feats: torch.Tensor, nbr_rows: torch.Tensor,
                weight: torch.Tensor, *, impl: str | None = None,
                nbr: "NeighbourList | None" = None) -> torch.Tensor:
    """K10 for a CUDA tensor (under autograd, the Function whose input
    gradient is K10 over the inverse list), the plain version for a CPU
    one or with ``impl="plain"``. ``nbr``: the NeighbourList that holds
    ``nbr_rows``, so that convs sharing a list build its inverse once."""
    if feats.dim() != 2 or feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_gemm: feats {feats.dtype} "
                         f"{tuple(feats.shape)}, need float32/bfloat16 "
                         f"[cap, Cin]")
    cap, cin = feats.shape
    if (nbr_rows.dim() != 2 or nbr_rows.shape[0] != cap
            or nbr_rows.dtype != torch.int32):
        raise ValueError(f"gather_gemm: nbr_rows {nbr_rows.dtype} "
                         f"{tuple(nbr_rows.shape)}, need int32 [{cap}, K]")
    K = nbr_rows.shape[1]
    if (weight.dim() != 3 or tuple(weight.shape[:2]) != (K, cin)
            or not weight.is_floating_point()):
        raise ValueError(f"gather_gemm: weight {tuple(weight.shape)}, need "
                         f"[{K}, {cin}, Cout]")
    for name, t in (("nbr_rows", nbr_rows), ("weight", weight)):
        if t.device != feats.device:
            raise ValueError(f"gather_gemm: {name} on {t.device}, feats on "
                             f"{feats.device}")
    if nbr is not None and nbr.rows is not nbr_rows:
        raise ValueError("gather_gemm: nbr does not hold nbr_rows")
    if not build.use_kernel(feats, impl):
        return gather_gemm_plain(feats, nbr_rows, weight)
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weight.requires_grad):
        return _GatherGemm.apply(
            feats, weight, nbr or NeighbourList(nbr_rows, cap, cap))
    return _forward(feats, nbr_rows, weight)


def _forward(feats, nbr_rows, weight) -> torch.Tensor:
    global launches
    out = _launch(feats, nbr_rows, weight)
    launches += 1
    return out


def _launch(feats, nbr_rows, weight) -> torch.Tensor:
    """One K10 launch: feats [cap, Cin] (the table and the output's rows),
    nbr_rows [cap, K], weight [K, Cin, Cout] -> [cap, Cout]."""
    cap, cin = feats.shape
    K, cout = nbr_rows.shape[1], weight.shape[2]
    if not fits(K, cin, feats.dtype):
        raise ValueError(f"gather_gemm: {K} taps of {cin} {feats.dtype} "
                         f"channels exceed K10's shared memory")
    out = torch.empty(cap, cout, dtype=feats.dtype, device=feats.device)
    if cap == 0:
        return out
    feats, nbr_rows = feats.contiguous(), nbr_rows.contiguous()
    co, coutp = chunking(cout)
    w = prep_weight(weight, feats.dtype)
    rc = build.lib().sgnn_gather_gemm(
        build.ptr(feats), build.ptr(nbr_rows), build.ptr(w), build.ptr(out),
        cap, K, cin, cout, coutp, co, vec_rows(feats, cin),
        build.is_bf16(feats), build.stream(feats),
    )
    build.check(rc, "gather_gemm")
    return out


class NeighbourList:
    """A neighbour list ``rows [cap_out, K]`` (row + 1 into a table of
    ``cap_in`` rows, 0 = missing) whose first ``num_out`` output rows are
    valid, and its inverse, built at the first input gradient that needs
    it and kept for every conv that shares the list."""

    def __init__(self, rows: torch.Tensor, num_out: int, cap_in: int):
        self.rows, self.num_out, self.cap_in = rows, int(num_out), cap_in
        self._inverse = None

    def inverse(self) -> torch.Tensor:
        if self._inverse is None:
            self._inverse = inverse_rows(self.rows, self.num_out,
                                         self.cap_in)
        return self._inverse


def inverse_rows(nbr_rows: torch.Tensor, num_out: int, cap_in: int
                 ) -> torch.Tensor:
    """int32 [cap_in, K]: inv[m, k] = n + 1 where nbr_rows[n, k] = m + 1
    and n < num_out, else 0. The targets are unique: a submanifold 3^3
    row's location is fixed by its neighbour's and the tap, and a fine row
    of the stride-2 list has one parent and one tap. The output rows from
    ``num_out`` on are dropped first, since padding rows with one location
    would collide."""
    rows = nbr_rows[:num_out].long()
    n, K = rows.shape
    inv = torch.zeros(cap_in, K, dtype=torch.int32, device=rows.device)
    out_row = torch.arange(1, n + 1, dtype=torch.int32,
                           device=rows.device)[:, None].expand(n, K)
    tap = torch.arange(K, device=rows.device)[None].expand(n, K)
    ok = (rows >= 1) & (rows <= cap_in)
    inv[rows[ok] - 1, tap[ok]] = out_row[ok]
    return inv


class _GatherGemm(torch.autograd.Function):
    """K10 forward; backward: dX by K10 over the inverse list (skipped
    when the features need no gradient, as the encoder's first conv's
    data), dW by tap-group matmuls."""

    @staticmethod
    def forward(ctx, feats, weight, nbr):
        ctx.save_for_backward(feats, weight)
        ctx.nbr = nbr
        return _forward(feats, nbr.rows, weight)

    @staticmethod
    def backward(ctx, g):
        feats, weight = ctx.saved_tensors
        nbr, g = ctx.nbr, g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_gemm_dx(g, nbr.rows, nbr.inverse(), weight,
                                nbr.num_out)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(feats, nbr.rows, g)
        return dx, dw, None


def gather_gemm_dx(g: torch.Tensor, nbr_rows: torch.Tensor,
                   inv_rows: torch.Tensor, weight: torch.Tensor,
                   num_out: int, *, impl: str | None = None
                   ) -> torch.Tensor:
    """The input gradient of ``gather_gemm``: g [cap, Cout] in the compute
    type -> dX [cap_in, Cin], dX[m] = sum over (n < num_out, k) with
    nbr_rows[n, k] = m + 1 of W[k] g[n], rounded once from f32 sums. On the
    card K10 over ``inv_rows`` with W^T [K, Cout, Cin] rounded to g's type;
    the plain version scatters each tap's g @ W[k]^T with index_add."""
    global dx_launches
    if not build.use_kernel(g, impl):
        return gather_gemm_dx_plain(g, nbr_rows, weight, num_out,
                                    inv_rows.shape[0])
    if inv_rows.shape[0] != g.shape[0]:
        raise ValueError(f"gather_gemm_dx: {inv_rows.shape[0]} input rows, "
                         f"{g.shape[0]} output rows: K10 takes one capacity")
    out = _launch(g, inv_rows, weight.transpose(1, 2))
    dx_launches += 1
    return out


def gather_gemm_dx_plain(g, nbr_rows, weight, num_out: int, cap_in: int
                         ) -> torch.Tensor:
    gf = g[:num_out].float()
    w = weight.to(g.dtype).float()
    rows = nbr_rows[:num_out].long()
    out = torch.zeros(cap_in + 1, weight.shape[1], dtype=torch.float32,
                      device=g.device)
    for k in range(weight.shape[0]):
        out.index_add_(0, rows[:, k], gf @ w[k].T)
    return out[1:].to(g.dtype)


def weight_grad(feats, nbr_rows, g) -> torch.Tensor:
    """dW [K, Cin, Cout] f32: per tap group the gathered rows' transpose
    times g, summed in f32."""
    cap, cin = feats.shape
    K = nbr_rows.shape[1]
    table = torch.cat([feats.new_zeros(1, cin), feats]).float()
    gf = g.float()
    parts = []
    for start, size in _tap_groups(K, cin):
        rows = nbr_rows[:, start:start + size].reshape(-1).long()
        lhs = table.index_select(0, rows).reshape(cap, size * cin)
        parts.append((lhs.T @ gf).reshape(size, cin, -1))
    return torch.cat(parts)


def gather_gemm_plain(feats: torch.Tensor, nbr_rows: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The tap-grouped form: a zero row prepended to the table, each tap
    group's gathered rows [cap, g * Cin] times its [g * Cin, Cout] weight
    slice, summed in f32 and rounded once. The gather is an index_select,
    whose backward is an index_add."""
    cap, cin = feats.shape
    K, _, cout = weight.shape
    table = torch.cat([feats.new_zeros(1, cin), feats]).float()
    w = weight.to(feats.dtype).float()
    out = torch.zeros(cap, cout, dtype=torch.float32, device=feats.device)
    for start, size in _tap_groups(K, cin):
        rows = nbr_rows[:, start:start + size].reshape(-1).long()
        lhs = table.index_select(0, rows).reshape(cap, size * cin)
        out = out + lhs @ w[start:start + size].reshape(size * cin, cout)
    return out.to(feats.dtype)
