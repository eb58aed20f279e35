"""The collectives of the sharded forwards and of data parallelism, with
their gradients: the counterparts of ``jax.lax.psum``, ``all_gather`` and
``ppermute`` over a process group.

A group is a ``torch.distributed`` ProcessGroup, or ``None`` for a group
of one rank (nothing to exchange). Each collective runs on the backend of
its group: on "nccl" the tensors stay on the card; on "gloo", which this
package never trusts with CUDA memory, a CUDA tensor is copied into a
pinned host buffer, exchanged there and copied back. Both are ordinary
paths chosen by the backend; neither is a fallback of the other.

Gradients follow the JAX package's step, which runs under ``shard_map(...,
check_vma=False)``: there the transpose of ``psum`` is a ``psum`` of the
cotangents (each rank's input receives the summed cotangent of every
rank's output), so ``all_reduce``'s backward is an all-reduce too;
``all_gather``'s is the all-reduced cotangent's own slice (a reduce-
scatter), and a neighbour exchange's is the reverse exchange.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.distributed as dist

_timer = None  # the active ``timing`` record


class _Timing:
    seconds = 0.0  # host-clock seconds in collectives
    calls = 0


@contextlib.contextmanager
def timing():
    """Record the host-clock time of every collective run inside the block
    (``.seconds``, ``.calls``). Each timed collective first waits for the
    card's queued work, so that the time is the exchange's own; the
    untimed path never synchronises beyond what its backend needs."""
    global _timer
    prev, _timer = _timer, _Timing()
    try:
        yield _timer
    finally:
        _timer = prev


def _timed(fn):
    @functools.wraps(fn)
    def run(t, *a):
        if _timer is None:
            return fn(t, *a)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(t, *a)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        _timer.seconds += time.perf_counter() - t0
        _timer.calls += 1
        return out
    return run


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _groups(groups) -> tuple:
    if groups is None:
        return ()
    if isinstance(groups, (tuple, list)):
        return tuple(g for g in groups if g is not None)
    return (groups,)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t: torch.Tensor, copy: bool = True) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape and type, holding ``t``."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if copy:
        h.copy_(t)
    return h


@_timed
def _sum_(t: torch.Tensor, groups: tuple) -> torch.Tensor:
    """In-place sum of a contiguous tensor over each group in turn."""
    for g in groups:
        if _staged(t, g):
            h = _host(t)
            dist.all_reduce(h, group=g)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=g)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.contiguous().clone(), ctx.groups), None


def all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``groups`` (a group, a tuple of
    groups whose product is the ranks to sum over, or None); its backward
    sums the cotangents the same way (psum's transpose under
    ``check_vma=False``)."""
    gs = _groups(groups)
    if not gs:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, gs)
    return _sum_(x.contiguous().clone(), gs)


def all_reduce_each(tensors: list, groups) -> list:
    """Each tensor summed over the ranks of ``groups`` (as ``all_reduce``,
    gradient included), in one all-reduce of their concatenation."""
    if not _groups(groups):
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), groups)
    parts = flat.split([t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


@_timed
def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    n = size(group)
    if _staged(x, group):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim).to(x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = _sum_(g.contiguous().clone(), (ctx.group,))
        i = index(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group order
    (``jax.lax.all_gather(tiled=True)``); a group of one returns x."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group, dim)
    return _gather(x, group, dim)


def _global(group, i: int) -> int:
    get = getattr(dist, "get_global_rank", None)
    if get is None:  # older releases
        get = dist.distributed_c10d._get_global_rank
    return get(group, i)


def _p2p_view(t: torch.Tensor) -> torch.Tensor:
    """Half-width floats travel as int16 (the bytes unchanged)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


@_timed
def _shift(down: torch.Tensor, up: torch.Tensor, group, batched=None):
    """Send ``down`` to the next rank of ``group`` and ``up`` to the
    previous one; returns (what the previous rank sent down, what the next
    rank sent up), zeros where there is no such rank. ``batched``: the
    four transfers as one ``batch_isend_irecv`` (NCCL's path, taken when
    None on an NCCL group; gloo runs it too for host tensors, which is
    how the CPU tests hold it), else separate ``isend``/``irecv`` through
    pinned host buffers for CUDA tensors."""
    n, i = size(group), index(group)
    down, up = down.contiguous(), up.contiguous()
    from_prev, from_next = torch.zeros_like(down), torch.zeros_like(up)
    if n == 1:
        return from_prev, from_next
    plan = []  # (is_send, tensor, peer's global rank)
    if i + 1 < n:
        nxt = _global(group, i + 1)
        plan += [(True, down, nxt), (False, from_next, nxt)]
    if i > 0:
        prv = _global(group, i - 1)
        plan += [(True, up, prv), (False, from_prev, prv)]
    if batched is None:
        batched = dist.get_backend(group) == "nccl"
    if batched:
        ops = [dist.P2POp(dist.isend if s else dist.irecv, t, peer, group)
               for s, t, peer in plan]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_prev, from_next
    staged = down.is_cuda
    bufs = [_host(t, copy=s) if staged else t for s, t, _ in plan]
    reqs = [(dist.isend if s else dist.irecv)(_p2p_view(b), peer,
                                              group=group)
            for (s, _, peer), b in zip(plan, bufs)]
    for req in reqs:
        req.wait()
    if staged:
        for (s, t, _), b in zip(plan, bufs):
            if not s:
                t.copy_(b)
    return from_prev, from_next


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, down, up, group, batched):
        ctx.group, ctx.batched = group, batched
        return _shift(down, up, group, batched)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # what we sent down came back as the next rank's g_prev, what we
        # sent up as the previous rank's g_next
        d_up, d_down = _shift(g_next, g_prev, ctx.group, ctx.batched)
        return d_down, d_up, None, None


def shift(down: torch.Tensor, up: torch.Tensor, group, batched=None):
    """``_shift`` with a gradient (the reverse exchange)."""
    if torch.is_grad_enabled() and (down.requires_grad or up.requires_grad):
        return _Shift.apply(down, up, group, batched)
    return _shift(down, up, group, batched)
