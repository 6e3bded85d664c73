"""Mamba-1 selective SSM block.

The port of ``repro.models.layers.mamba``.  The reference runs the
recurrence as a chunked scan (``lax.scan`` over chunks of
``SCAN_CHUNK`` steps, an associative scan inside each) and then reads
``y = sum_st h * C`` out of every state.  Here the whole recurrence and
the readout are one call of the selective-scan kernel,
:func:`repro_torch.kernels.mamba_scan.ops.scan` (K3): on a CUDA tensor it
launches the hand-written Hopper kernel, on a CPU tensor it runs the
kernel's plain version.  K3 returns ``y`` and ``h_last`` and never
materializes the (B, S, d_inner, d_state) states.  Decode is a one-step
recurrence in plain PyTorch, as in the reference.

The reference differentiates ``_ssm_inputs`` and its own scan with JAX
autodiff.  Here ``mamba_forward`` hands the scan's inputs before the
tail, (dt, A, u = dt x1, Bc, C), to
:class:`~repro_torch.kernels.mamba_scan.ops.SelectiveScan`, an autograd
Function that builds ``a = exp(dt A)`` and ``b = u Bc`` with the same ops
as ``_ssm_inputs``, runs K3 and drops them.  Its backward is the fused
backward of the scan and that tail (``ops.ssm_backward``): the
hand-written Hopper kernel on a CUDA tensor, its plain version on a CPU
one; it neither keeps nor makes a (B, S, d_inner, d_state) tensor.  Under
``no_grad`` or ``inference_mode`` it runs the forward alone and records
nothing, so serving launches K3 alone.  Decode keeps ``_ssm_inputs``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from .common import normal_init

Params = Dict[str, Any]

SCAN_CHUNK = 256


def init_mamba(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d, di, st = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
    dr, dc = cfg.ssm_dt_rank_, cfg.ssm_d_conv
    dt = cfg.param_dtype
    dev = gen.device
    A = torch.arange(1, st + 1, dtype=torch.float32,
                     device=dev).expand(*lead, di, st)
    return {
        "in_proj": normal_init(gen, (*lead, d, 2 * di), dt, d ** -0.5),
        "conv_w": normal_init(gen, (*lead, dc, di), dt, dc ** -0.5),
        "conv_b": torch.zeros((*lead, di), dtype=dt, device=dev),
        "x_proj": normal_init(gen, (*lead, di, dr + 2 * st), dt, di ** -0.5),
        "dt_proj": normal_init(gen, (*lead, dr, di), dt, dr ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.full(
            (*lead, di), 0.01, dtype=torch.float32, device=dev))),
        "A_log": torch.log(A),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": normal_init(gen, (*lead, di, d), dt, di ** -0.5),
    }


def _ssm_params(cfg, p: Params, x1: torch.Tensor, tp=None):
    """x1: (B, S, di) post-conv -> the scan's inputs before the tail: dt
    (B, S, di) f32 after the softplus, A (di, st) f32, u = dt * x1 (f32),
    and B, C ((B, S, st) in x1's dtype).  With `tp` x1 and the weights
    are this rank's di shard: ``x1 @ x_proj`` contracts di, so its
    partial sums are all-reduced, and its gradient too (every rank's dt,
    B and C feed its own channels)."""
    st = cfg.ssm_d_state
    dr = cfg.ssm_dt_rank_
    proj = x1 @ p["x_proj"]
    if tp is not None:
        proj = tp.all_reduce(proj)
    dt_raw, Bc, Cc = torch.split(proj, [dr, st, st], dim=-1)
    dt = F.softplus((dt_raw @ p["dt_proj"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])  # (di, st)
    return dt, A, dt * x1.float(), Bc, Cc


def _ssm_inputs(cfg, p: Params, x1: torch.Tensor):
    """x1: (B, S, di) post-conv -> per-step decay a and input b (f32,
    (B, S, di, st)), readout C ((B, S, st) in x1's dtype)."""
    dt, A, u, Bc, Cc = _ssm_params(cfg, p, x1)
    # in place on the product: exp's backward reads its own output, the
    # product's backward its inputs, so autograd allows it
    a = torch.exp_(dt[..., None] * A)                                # (B,S,di,st)
    b = u[..., None] * Bc.float()[:, :, None, :]
    return a, b, Cc


def _causal_conv(p: Params, x1: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d as a sum of shifted copies (kernel is tiny)."""
    dc = p["conv_w"].shape[0]
    out = x1 * p["conv_w"][dc - 1]
    for i in range(1, dc):
        shifted = F.pad(x1[:, :-i], (0, 0, i, 0))
        out = out + shifted * p["conv_w"][dc - 1 - i]
    return out + p["conv_b"]


def mamba_forward(cfg, p: Params, x: torch.Tensor, tp=None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba (train/prefill). Returns (out, decode cache).
    The scan is one K3 call (:mod:`repro_torch.kernels.mamba_scan`), and
    one call of the fused backward of the scan and its tail in backward.

    With `tp` (a model-axis group) the layer runs on this rank's shard of
    the SSM channels: ``in_proj`` arrives whole (its x1 and z halves
    would split unevenly) and the rank takes its di columns of each half;
    every other weight arrives as its di shard.  The scan is per channel,
    so K3 and its backward run on the rank's channels with no
    communication; ``x_proj`` and ``out_proj`` each need one all-reduce."""
    di, st, dc = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    if tp is None:
        xz = x @ p["in_proj"]
    else:
        x = tp.copy_in(x)
        di = di // tp.size
        lo = tp.rank * di
        w = p["in_proj"]
        half = w.shape[-1] // 2
        xz = x @ torch.cat([w[:, lo:lo + di], w[:, half + lo:half + lo + di]],
                           dim=-1)
    B, S, _ = x.shape   # after copy_in: the whole sequence
    x1, z = torch.chunk(xz, 2, dim=-1)
    x1_pre = x1
    x1 = F.silu(_causal_conv(p, x1).float()).to(x.dtype)

    dt, A, u, Bc, Cc = _ssm_params(cfg, p, x1, tp)
    chunk = min(SCAN_CHUNK, S)
    assert S % chunk == 0, (S, chunk)
    h0 = torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
    # a and b, (B, S, di, st) f32 each, live only inside the Function's
    # forward
    y, h_last = scan_ops.SelectiveScan.apply(
        dt, A, u, Bc.float().contiguous(), Cc.float().contiguous(), h0)

    y = y + p["D"] * x1.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if tp is not None:
        out = tp.reduce_out(out)

    if S >= dc - 1:
        conv = x1_pre[:, S - (dc - 1):, :].clone()
    else:
        conv = F.pad(x1_pre, (0, 0, dc - 1 - S, 0))
    return out, {"conv": conv, "h": h_last}


def mamba_decode(cfg, p: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token Mamba step. x: (B,1,d); cache: conv (B,dc-1,di), h (B,di,st)."""
    xz = x @ p["in_proj"]
    x1, z = torch.chunk(xz, 2, dim=-1)                               # (B,1,di)

    window = torch.cat([cache["conv"], x1], dim=1)                   # (B,dc,di)
    conv_out = torch.einsum("bci,ci->bi", window, p["conv_w"]) + p["conv_b"]
    x1c = F.silu(conv_out.float()).to(x.dtype)[:, None, :]

    a, b, Cc = _ssm_inputs(cfg, p, x1c)                              # (B,1,di,st)
    h = a[:, 0] * cache["h"] + b[:, 0]                               # (B,di,st)
    y = torch.einsum("bin,bn->bi", h, Cc[:, 0].float())
    y = y + p["D"] * x1c[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": window[:, 1:], "h": h}
