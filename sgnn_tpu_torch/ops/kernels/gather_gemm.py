"""K10: the fused neighbour gather and tap GEMM of the coordinate-list
sparse conv (csrc/gather_gemm.cu).

Port of sgnn_tpu/ops/pallas/gather_gemm.py ``gather_gemm_pallas`` (:62),
with its contract ``(feats, nbr_rows, weight)``:

    out[n] = round(sum_k feats[nbr_rows[n, k] - 1] @ W[k])    f32 sums

``feats [cap, Cin]`` in the compute type, ``nbr_rows [cap, K]`` int32
row + 1 (0 = missing), ``weight [K, Cin, Cout]`` rounded to feats' type;
the output ``[cap, Cout]`` is in feats' type, rounded once. On the card
every call launches the kernel: the JAX package's gate (the
``SGNN_TPU_PALLAS_GATHER`` flag and the 12 MB VMEM table limit) was a
Mosaic workaround. The plain version is the tap-grouped form of
sgnn_tpu/ops/conv.py ``gather_gemm`` (:101-111).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sgnn_tpu_torch.ops.kernels import build

launches = 0  # kernel launches since the last reset_launch_counts()


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


def _tap_groups(num_taps: int, cin: int, target_k: int = 128) -> list:
    """Taps in groups of ~target_k / cin: [(start, size)]."""
    g = max(1, min(num_taps, target_k // max(cin, 1)))
    return [(s, min(g, num_taps - s)) for s in range(0, num_taps, g)]


def gather_gemm(feats: torch.Tensor, nbr_rows: torch.Tensor,
                weight: torch.Tensor, *, impl: str | None = None
                ) -> torch.Tensor:
    global launches
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
    if not build.use_kernel(feats, impl):
        return gather_gemm_plain(feats, nbr_rows, weight)
    cout = weight.shape[2]
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
    launches += 1
    build.check(rc, "gather_gemm")
    return out


def gather_gemm_plain(feats: torch.Tensor, nbr_rows: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The tap-grouped form: a zero row prepended to the table, each tap
    group's gathered rows [cap, g * Cin] times its [g * Cin, Cout] weight
    slice, summed in f32 and rounded once."""
    cap, cin = feats.shape
    K, _, cout = weight.shape
    table = torch.cat([feats.new_zeros(1, cin), feats]).float()
    w = weight.to(feats.dtype).float()
    out = torch.zeros(cap, cout, dtype=torch.float32, device=feats.device)
    for start, size in _tap_groups(K, cin):
        rows = nbr_rows[:, start:start + size].long()
        lhs = table[rows].reshape(cap, size * cin)
        out = out + lhs @ w[start:start + size].reshape(size * cin, cout)
    return out.to(feats.dtype)
