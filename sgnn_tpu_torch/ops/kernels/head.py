"""K4: the fused per-voxel head site (csrc/head.cu), in its two modes.

Port of sgnn_tpu/ops/pallas/conv3d_folded.py ``fused_head_folded``
(:1687).

``head_gate`` (gate=True; a refinement level's tail): BN affine + ReLU +
mask -> occ|sdf head -> gate out2[0] > 0 -> (masked post-BN feats, masked
heads, new mask). With ``mask_scale=2`` the level mask is the coarse
level's grid, expanded in place. With ``emit_raw=True`` (the training
path) a fourth output is the f32 head grid out2 = lhs @ W + b before the
gate, at every interior slot (ring unspecified); those launches count
under ``gate_raw_launches``, so the serving counts stay as they were.

``head_sum`` (gate=False; the surface head): per group eval-BN + ReLU +
mask, summed head GEMMs + bias -> raw f32 grid (ring unspecified).

``w`` rows are input channels, columns head outputs, zero-padded to 16 and
rounded to the compute type; ``bias [16]`` and ``aff [.., 2, 16]`` f32.
"""

from __future__ import annotations

import torch

from sgnn_tpu_torch.ops.kernels import build

LANES = 128
gate_launches = 0  # head_gate kernel launches since the last reset
gate_raw_launches = 0  # head_gate launches with the raw f32 output
sum_launches = 0   # head_sum kernel launches since the last reset


def _fine_mask(mask: torch.Tensor, mask_scale: int, B: int, Z: int, Y: int,
               Xs: int, cpad: int) -> torch.Tensor:
    """[B, Z, Y, Xs] f32 level mask at the head's resolution (interior)."""
    Zmp, Ymp, xqm = mask.shape[1:4]
    Xms = xqm * (LANES // cpad)
    m = mask.view(B, Zmp, Ymp, Xms, cpad)[:, 1:-1, 1:-1, :, 0].float()
    if mask_scale == 2:
        for ax in (1, 2, 3):
            m = m.repeat_interleave(2, dim=ax)
        if m.shape[3] < Xs:
            m = torch.nn.functional.pad(m, (0, Xs - m.shape[3]))
    return m[:, :Z, :Y, :Xs]


def head_gate(x: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor, aff: torch.Tensor, cpad: int, *,
              mask_scale: int = 1, emit_raw: bool = False,
              impl: str | None = None):
    global gate_launches, gate_raw_launches
    if cpad not in (8, 16) or mask_scale not in (1, 2):
        raise ValueError(f"head_gate: cpad {cpad}, mask_scale {mask_scale}")
    build.check_grid("x", x, x)
    build.check_grid("mask", mask, x)
    build.check_f32("w", w, (16, 16), x)
    build.check_f32("bias", bias, (16,), x)
    build.check_f32("aff", aff, (2, 16), x)
    B, Zp, Yp, xq, _ = x.shape
    Zmp, Ymp, xqm = mask.shape[1:4]
    if mask_scale == 1 and mask.shape != x.shape:
        raise ValueError(f"head_gate: mask {tuple(mask.shape)} != x")
    if mask_scale == 2 and ((Zmp - 2) * 2 != Zp - 2
                            or (Ymp - 2) * 2 != Yp - 2 or 2 * xqm < xq):
        raise ValueError(f"head_gate: coarse mask {tuple(mask.shape)} does "
                         f"not cover x {tuple(x.shape)}")
    if not build.use_kernel(x, impl):
        return head_gate_plain(x, mask, w, bias, aff, cpad,
                               mask_scale=mask_scale, emit_raw=emit_raw)
    upm, o2m, fmn = (torch.empty_like(x) for _ in range(3))
    raw = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
           if emit_raw else None)
    rc = build.lib().sgnn_head_gate(
        build.ptr(x), build.ptr(mask), build.ptr(w), build.ptr(bias),
        build.ptr(aff), mask_scale, build.ptr(upm),
        build.ptr(o2m), build.ptr(fmn), build.ptr(raw), B, Zp, Yp, xq, Zmp,
        Ymp, xqm, cpad, build.is_bf16(x), build.stream(x),
    )
    if emit_raw:
        gate_raw_launches += 1
    else:
        gate_launches += 1
    build.check(rc, "head_gate")
    return (upm, o2m, fmn, raw) if emit_raw else (upm, o2m, fmn)


def head_gate_plain(x, mask, w, bias, aff, cpad, *, mask_scale=1,
                    emit_raw=False):
    dt = x.dtype
    B, Zp, Yp, xq, _ = x.shape
    Xs = xq * (LANES // cpad)
    m = _fine_mask(mask, mask_scale, B, Zp - 2, Yp - 2, Xs, cpad)[..., None]
    t = x.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1].float()
    t = (t * aff[0, :cpad] + aff[1, :cpad]).clamp_min(0.0)
    lhs = (t * m).to(dt).float()
    out2 = torch.matmul(lhs, w[:cpad, :cpad]) + bias[:cpad]
    g = torch.where(out2[..., :1] > 0.0, m, torch.zeros_like(m))
    res = [(lhs * g).to(dt), (out2.to(dt).float() * g).to(dt),
           g.expand(-1, -1, -1, -1, cpad).to(dt)]
    if emit_raw:
        res.append(out2)
    outs = []
    for r in res:
        o = torch.zeros(B, Zp, Yp, Xs, cpad, dtype=r.dtype, device=x.device)
        o[:, 1:-1, 1:-1] = r
        outs.append(o.view(B, Zp, Yp, xq, LANES))
    return tuple(outs)


def head_sum(xs: list, mask: torch.Tensor, w: torch.Tensor,
             bias: torch.Tensor, aff: torch.Tensor, cins: list, cpad: int,
             *, impl: str | None = None) -> torch.Tensor:
    global sum_launches
    G = len(xs)
    if len(cins) != G or not 1 <= G <= 4 or cpad not in (8, 16):
        raise ValueError(f"head_sum: G={G}, cins={cins}, cpad={cpad}")
    if max(cins) > cpad:
        raise ValueError(f"head_sum: widths {cins} exceed cpad {cpad}")
    for i, x in enumerate(xs):
        build.check_grid(f"xs[{i}]", x, mask)
    build.check_grid("mask", mask, mask)
    build.check_f32("w", w, (G, 16, 16), mask)
    build.check_f32("bias", bias, (16,), mask)
    build.check_f32("aff", aff, (G, 2, 16), mask)
    if not build.use_kernel(mask, impl):
        return head_sum_plain(xs, mask, w, bias, aff, cins, cpad)
    B, Zp, Yp, xq, _ = mask.shape
    out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    rc = build.lib().sgnn_head_sum(
        build.ptr_array(xs), build.int_array(cins), G, build.ptr(mask),
        build.ptr(w), build.ptr(bias), build.ptr(aff),
        build.ptr(out), B, Zp, Yp, xq, cpad, build.is_bf16(mask),
        build.stream(mask),
    )
    sum_launches += 1
    build.check(rc, "head_sum")
    return out


def head_sum_plain(xs, mask, w, bias, aff, cins, cpad):
    dt = mask.dtype
    B, Zp, Yp, xq, _ = mask.shape
    Xs = xq * (LANES // cpad)
    m = mask.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1, :, :1].float()
    acc = None
    for g, (x, cin) in enumerate(zip(xs, cins)):
        t = x.view(B, Zp, Yp, Xs, cpad)[:, 1:-1, 1:-1, :, :cin].float()
        t = (t * aff[g, 0, :cin] + aff[g, 1, :cin]).clamp_min(0.0)
        lhs = (t * m).to(dt).float()
        y = torch.matmul(lhs, w[g, :cin, :cpad])
        acc = y if acc is None else acc + y
    out = torch.zeros(B, Zp, Yp, Xs, cpad, dtype=torch.float32,
                      device=mask.device)
    out[:, 1:-1, 1:-1] = acc + bias[:cpad]
    return out.view(B, Zp, Yp, xq, LANES)
