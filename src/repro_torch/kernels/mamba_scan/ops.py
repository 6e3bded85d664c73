"""Public wrapper for the Mamba selective-scan kernel (autotuned blocks).

For a CUDA tensor :func:`scan` launches the hand-written kernel
(:mod:`.mamba_scan`) or raises — it never falls back.  For a CPU tensor
it runs the plain version (:mod:`.ref`), which is what the CPU tests
reach.  ``LAUNCHES`` counts kernel launches and nothing else.

:func:`scan_backward` is the same for the backward (K3-bwd), counted in
``BWD_LAUNCHES``.  :class:`Scan` joins the two as a
``torch.autograd.Function``: the gradient of the op-level scan.

:func:`ssm_backward` is the fused backward of the scan and its input
tail ``a = exp(dt A)``, ``b = u Bc``, counted in ``SSM_BWD_LAUNCHES``.
:class:`SelectiveScan` takes (dt, A, u, Bc, C, h0), builds a and b, runs
:func:`scan` and drops them; its backward is :func:`ssm_backward`, so no
(B, S, d_inner, d_state) tensor is kept for or made by the backward.  It
is what the model calls.  Under ``no_grad`` or ``inference_mode`` either
Function's ``apply`` runs the forward alone and records nothing, so
inference launches exactly the forward kernel.

Fake tensors (``FakeTensorMode``, the dry-run's trace) meet a shape rule
in each wrapper, ahead of the device checks: outputs of the kernel's
shapes, dtypes and device, with no launch, no count and no plain
version.  Meta tensors are not fake and still raise.  Under a dispatch
mode (``FlopCounterMode``) every wrapper also issues
``repro_torch::selective_scan_cost``, an op that computes nothing and
whose registered FLOP formula is the analytic model's (the
associative-scan term and the C readout; a backward twice that), so the
counter sees the scan as ``roofline.analytic`` counts it.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import autotune
from repro_torch.roofline.terms import ssm_scan_terms
from . import mamba_scan as kernel
from . import ref

LAUNCHES = 0
BWD_LAUNCHES = 0
SSM_BWD_LAUNCHES = 0
_count_lock = threading.Lock()


@torch.library.custom_op("repro_torch::selective_scan_cost", mutates_args=())
def _scan_cost(a: torch.Tensor, C: torch.Tensor, backward: bool) -> None:
    """Computes nothing: a mark for ``FlopCounterMode`` of one scan
    (a: (B,S,di) or (B,S,di,st), C: (B,S,st)), forward or backward."""


@_scan_cost.register_fake
def _(a, C, backward):
    return None


@register_flop_formula(torch.ops.repro_torch.selective_scan_cost)
def _scan_flops(a_shape, C_shape, backward, out_shape=None, **kwargs) -> int:
    B, S, di = a_shape[:3]
    # the terms of roofline.analytic._ssm_flops; a backward is 2x
    fwd = sum(ssm_scan_terms(B, S, di, C_shape[-1]))
    return 2 * fwd if backward else fwd


def _mark(a: torch.Tensor, C: torch.Tensor, backward: bool) -> None:
    """Issue the cost mark when a dispatch mode could read it."""
    if isinstance(a, FakeTensor) or torch._C._len_torch_dispatch_stack():
        _scan_cost(a, C, backward)


def resolve_blocks(S: int, di: int, st: int, dtype: torch.dtype, device,
                   bdi: Optional[int], bs: Optional[int]) -> Tuple[int, int]:
    """Block sizes for the scan: explicit args win, else the autotune
    registry, else :data:`autotune.DEFAULTS`.  Not snapped to divisors:
    the kernel masks rows past d_inner and steps past S itself."""
    if bdi is None or bs is None:
        tuned = autotune.lookup("mamba_scan", {"S": S, "di": di, "st": st},
                                dtype, device) \
            or autotune.DEFAULTS["mamba_scan"]
        bdi = bdi if bdi is not None else tuned["bdi"]
        bs = bs if bs is not None else tuned["bs"]
    return bdi, bs


def scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
         h0: torch.Tensor, *, bdi: Optional[int] = None,
         bs: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan. a,b: (B,S,di,st); C: (B,S,st); h0: (B,di,st), f32
    or bf16 (upcast) -> (y (B,S,di) f32, h_last (B,di,st) f32)."""
    _mark(a, C, False)
    if isinstance(a, FakeTensor):                  # shape rule only
        B, S, di, st = a.shape
        f32 = torch.float32
        return (a.new_empty((B, S, di), dtype=f32),
                a.new_empty((B, di, st), dtype=f32))
    if a.device.type == "cpu":
        return ref.scan(a, b, C, h0)
    if a.device.type != "cuda":
        raise ValueError(f"scan: unsupported device {a.device}")
    if a.ndim != 4:
        raise ValueError(f"scan: a has shape {tuple(a.shape)}, not "
                         "(B, S, di, st)")
    B, S, di, st = a.shape
    want = {"b": (B, S, di, st), "C": (B, S, st), "h0": (B, di, st)}
    for name, t in (("b", b), ("C", C), ("h0", h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"scan: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")
    for t in (a, b, C, h0):
        if t.device != a.device:
            raise ValueError(f"scan: inputs on {t.device} and {a.device}")
        if t.dtype != a.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError("scan: inputs must share one dtype, f32 or "
                            f"bf16; got {t.dtype} and {a.dtype}")
        if not t.is_contiguous():
            raise ValueError("scan: inputs must be contiguous")
    if not 1 <= st <= kernel.MAX_ST:
        raise ValueError(f"scan: st={st} outside 1..{kernel.MAX_ST}, the "
                         "state widths the kernel is built for")
    if min(B, S, di) < 1 or B > 65535 or max(S, di) >= 2**31:
        raise ValueError(f"scan: shape {tuple(a.shape)} out of range")
    bdi, bs = resolve_blocks(S, di, st, a.dtype, a.device, bdi, bs)
    if bs not in kernel.BS_BUILT:
        raise ValueError(f"scan: bs={bs} not in {kernel.BS_BUILT}")
    if bdi < 1 or kernel.threads(bdi, st) > kernel.MAX_THREADS:
        raise ValueError(f"scan: bdi={bdi} gives a block of "
                         f"{kernel.threads(bdi, st)} threads, over "
                         f"{kernel.MAX_THREADS}")
    y = torch.empty((B, S, di), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, di, st), dtype=torch.float32, device=a.device)
    kernel.scan_cuda(a, b, C, h0, y, h_last, bdi=bdi, bs=bs)
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1
    return y, h_last


def scan_backward(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
                  h0: torch.Tensor, dy: Optional[torch.Tensor],
                  dh_last: Optional[torch.Tensor], *,
                  need: Tuple[bool, ...] = (True, True, True, True)
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of :func:`scan`: cotangents dy (B,S,di) and dh_last
    (B,di,st), either None for zero -> (da, db, dC, dh0) in the inputs'
    dtypes, None where `need` is False."""
    _mark(a, C, True)
    if isinstance(a, FakeTensor):                  # shape rule only
        return tuple(t.new_empty(t.shape) if n else None
                     for t, n in zip((a, b, C, h0), need))
    if a.device.type == "cpu":
        out = ref.scan_backward(a, b, C, h0, dy, dh_last)
        return tuple(g if n else None for g, n in zip(out, need))
    if a.device.type != "cuda":
        raise ValueError(f"scan_backward: unsupported device {a.device}")
    B, S, di, st = a.shape
    want = {"b": (B, S, di, st), "C": (B, S, st), "h0": (B, di, st),
            "dy": (B, S, di), "dh_last": (B, di, st)}
    for name, t in (("b", b), ("C", C), ("h0", h0), ("dy", dy),
                    ("dh_last", dh_last)):
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"scan_backward: {name} has shape "
                             f"{tuple(t.shape)}, want {want[name]}")
        if t.device != a.device:
            raise ValueError(f"scan_backward: inputs on {t.device} and "
                             f"{a.device}")
    for t in (a, b, C, h0):
        if t.dtype != a.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError("scan_backward: inputs must share one dtype, "
                            f"f32 or bf16; got {t.dtype} and {a.dtype}")
        if not t.is_contiguous():
            raise ValueError("scan_backward: inputs must be contiguous")
    if not 1 <= st <= kernel.MAX_ST:
        raise ValueError(f"scan_backward: st={st} outside 1..{kernel.MAX_ST}")
    if min(B, S, di) < 1 or B > 65535 or max(S, di) >= 2**31:
        raise ValueError(f"scan_backward: shape {tuple(a.shape)} out of "
                         "range")
    # the cotangents arrive from autograd in any layout: f32, contiguous
    dy = None if dy is None else dy.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    da, db = torch.empty_like(a), torch.empty_like(b)
    dC = torch.empty_like(C) if need[2] else None
    dh0 = torch.empty_like(h0) if need[3] else None
    kernel.scan_backward_cuda(a, b, C, h0, dy, dh_last, da, db, dC, dh0,
                              bdi=kernel.bwd_rows(st))
    global BWD_LAUNCHES
    with _count_lock:
        BWD_LAUNCHES += 1
    return (da if need[0] else None, db if need[1] else None, dC, dh0)


class Scan(torch.autograd.Function):
    """:func:`scan` with :func:`scan_backward` as its gradient.  The
    forward saves a, b, C and h0; the backward rebuilds h from them."""

    @staticmethod
    def forward(ctx, a, b, C, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b, C, h0)
        return scan(a, b, C, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        if dy is None and dh_last is None:
            return None, None, None, None
        return scan_backward(*ctx.saved_tensors, dy, dh_last,
                             need=ctx.needs_input_grad)


def ssm_backward(dt: torch.Tensor, A: torch.Tensor, u: torch.Tensor,
                 Bc: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                 dy: Optional[torch.Tensor], dh_last: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`scan` on a = exp(dt * A), b = u * Bc, for
    dt, u (B,S,di), A (di,st), Bc, C (B,S,st), h0 (B,di,st), all f32, and
    cotangents dy (B,S,di), dh_last (B,di,st), either None for zero ->
    (ddt, dA, du, dBc, dC, dh0), f32."""
    _mark(dt, C, True)
    if isinstance(dt, FakeTensor):                 # shape rule only
        return tuple(t.new_empty(t.shape)
                     for t in (dt, A, u, Bc, C, h0))
    if dt.device.type == "cpu":
        return ref.ssm_backward(dt, A, u, Bc, C, h0, dy, dh_last)
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_backward: unsupported device {dt.device}")
    if dt.ndim != 3 or A.ndim != 2:
        raise ValueError(f"ssm_backward: dt {tuple(dt.shape)} and A "
                         f"{tuple(A.shape)}, want (B, S, di) and (di, st)")
    B, S, di = dt.shape
    st = A.shape[1]
    want = {"A": (di, st), "u": (B, S, di), "Bc": (B, S, st),
            "C": (B, S, st), "h0": (B, di, st), "dy": (B, S, di),
            "dh_last": (B, di, st)}
    named = (("A", A), ("u", u), ("Bc", Bc), ("C", C), ("h0", h0),
             ("dy", dy), ("dh_last", dh_last))
    for name, t in named:
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssm_backward: {name} has shape "
                             f"{tuple(t.shape)}, want {want[name]}")
        if t.device != dt.device:
            raise ValueError(f"ssm_backward: inputs on {t.device} and "
                             f"{dt.device}")
    for t in (dt, A, u, Bc, C, h0):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_backward: inputs must be f32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("ssm_backward: inputs must be contiguous")
    if not 1 <= st <= kernel.MAX_ST:
        raise ValueError(f"ssm_backward: st={st} outside 1..{kernel.MAX_ST}")
    if min(B, S, di) < 1 or B > 65535 or max(S, di) >= 2**31:
        raise ValueError(f"ssm_backward: shape {(B, S, di, st)} out of range")
    # the cotangents arrive from autograd in any layout: f32, contiguous
    dy = None if dy is None else dy.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    ddt, du = torch.empty_like(dt), torch.empty_like(u)
    dBc, dC = torch.empty_like(Bc), torch.empty_like(C)
    dA, dh0 = torch.empty_like(A), torch.empty_like(h0)
    kernel.ssm_backward_cuda(dt, A, u, Bc, C, h0, dy, dh_last, ddt, du, dBc,
                             dC, dA, dh0)
    global SSM_BWD_LAUNCHES
    with _count_lock:
        SSM_BWD_LAUNCHES += 1
    return ddt, dA, du, dBc, dC, dh0


class SelectiveScan(torch.autograd.Function):
    """:func:`scan` on a = exp(dt * A), b = u * Bc, with
    :func:`ssm_backward` as its gradient.  The forward builds a and b with
    the model's own ops (so its outputs are those of ``Scan.apply(a, b,
    C, h0)`` bit for bit), drops them after K3 and saves only dt, A, u,
    Bc, C and h0."""

    @staticmethod
    def forward(ctx, dt, A, u, Bc, C, h0):
        ctx.set_materialize_grads(False)
        a = torch.exp_(dt[..., None] * A)                   # (B,S,di,st)
        b = u[..., None] * Bc[:, :, None, :]
        ctx.save_for_backward(dt, A, u, Bc, C, h0)
        return scan(a, b, C, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        if dy is None and dh_last is None:
            return (None,) * 6
        grads = ssm_backward(*ctx.saved_tensors, dy, dh_last)
        return tuple(g if n else None
                     for g, n in zip(grads, ctx.needs_input_grad))
