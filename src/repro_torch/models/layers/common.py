"""Shared model primitives: norms, RoPE, SwiGLU MLP, embeddings.

The port of ``repro.models.layers.common`` with the same cast points:
RMSNorm's variance in f32, RoPE in f32, SwiGLU's silu in f32, logits in
f32.  Inits draw from an explicit ``torch.Generator`` on its own device;
``lead`` prepends stacked-layer axes to every leaf.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def normal_init(gen: torch.Generator, shape, dtype, stddev: float):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * stddev).to(dtype)


# ---------------------------------------------------------------- RMSNorm
def init_rmsnorm(d: int, gen: torch.Generator, lead: Tuple = ()) -> Params:
    return {"scale": torch.ones((*lead, d), device=gen.device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the square in x's dtype, the mean accumulated in f32 (as jnp.mean
    # with dtype=f32 does)
    var = x.square().mean(dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ---------------------------------------------------------------- RoPE
def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 1 + 0.1 mscale ln(factor) above a factor
    of 1, else 1."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_freqs(pw: torch.Tensor, head_dim: int, theta: float, yarn
                ) -> torch.Tensor:
    """YaRN's inverse frequencies from ``pw = theta ** (2i / head_dim)``:
    ``1 / (factor pw)`` below the correction range that ``beta_fast``
    and ``beta_slow`` rotations bound, ``1 / pw`` above it, a linear ramp
    between."""
    factor, orig, beta_fast, beta_slow = yarn[:4]

    def dim_of(rotations):
        return (head_dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim_of(beta_fast)), 0)
    high = min(math.ceil(dim_of(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=pw.device)
    extra = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    return 1.0 / (factor * pw) * (1 - extra) + 1.0 / pw * extra


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                yarn=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2).
    With `yarn` (``ModelConfig.rope_yarn``) the frequencies are YaRN's and
    cos/sin are scaled by ``yarn_mscale(factor, mscale) /
    yarn_mscale(factor, mscale_all_dim)``."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    pw = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                device=positions.device), exps)
    freqs = _yarn_freqs(pw, head_dim, theta, yarn) if yarn else 1.0 / pw
    ang = positions.float()[..., None] * freqs  # (..., half)
    if not yarn:
        return torch.cos(ang), torch.sin(ang)
    scale = yarn_mscale(yarn[0], yarn[4]) / yarn_mscale(yarn[0], yarn[5])
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); cos/sin: (..., S, head_dim//2)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


# ---------------------------------------------------------------- SwiGLU MLP
def init_mlp(cfg, gen: torch.Generator, d_ff: int, lead: Tuple = ()
             ) -> Params:
    d = cfg.d_model
    dt = cfg.param_dtype
    s_in = d ** -0.5
    s_out = d_ff ** -0.5
    return {
        "w_gate": normal_init(gen, (*lead, d, d_ff), dt, s_in),
        "w_up": normal_init(gen, (*lead, d, d_ff), dt, s_in),
        "w_down": normal_init(gen, (*lead, d_ff, d), dt, s_out),
    }


def mlp(p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU.  With `tp` (a model-axis group) the weights are this
    rank's d_ff shard: column- then row-parallel, one all-reduce out."""
    if tp is not None:
        x = tp.copy_in(x)
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    out = h @ p["w_down"]
    return out if tp is None else tp.reduce_out(out)


# ---------------------------------------------------------------- Embedding
def init_embedding(cfg, gen: torch.Generator) -> Params:
    dt = cfg.param_dtype
    p = {"embed": normal_init(gen, (cfg.vocab_padded, cfg.d_model), dt, 0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal_init(gen, (cfg.vocab_padded, cfg.d_model), dt,
                                   cfg.d_model ** -0.5)
    return p


def embed(p: Params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token rows of the table.  With `tp` the table is this rank's vocab
    shard: each rank fills the rows it owns (zeros elsewhere) and one
    all-reduce adds them, exactly."""
    table = p["embed"]
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    idx = tokens.long() - tp.rank * n
    mine = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return tp.reduce_out(rows)


def unembed(cfg, p: Params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits over the padded vocab; padding ids masked to -1e30.  With
    `tp` the table is this rank's vocab shard and so are the logits."""
    table = p["embed"] if cfg.tie_embeddings else p["lm_head"]
    if tp is not None:
        x = tp.copy_in(x)
    logits = (x @ table.T).float()
    if cfg.vocab_padded != cfg.vocab_size:
        lo = 0 if tp is None else tp.rank * table.shape[0]
        pad_mask = torch.arange(lo, lo + table.shape[0],
                                device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


def sharded_nll(logits: torch.Tensor, labels: torch.Tensor, tp
                ) -> torch.Tensor:
    """Per-token NLL from this rank's vocab shard of f32 logits: the
    log-sum-exp over the whole vocab from a max and a sum all-reduced
    over the model axis, the gold logit from the rank that owns it (the
    logits are never gathered)."""
    n = logits.shape[-1]
    m = tp.max(logits.max(dim=-1).values)
    s = tp.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1))
    logz = m + torch.log(s)
    idx = labels.long() - tp.rank * n
    mine = (idx >= 0) & (idx < n)
    gold = logits.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = tp.reduce_out(torch.where(mine, gold, 0.0))
    return logz - gold


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of f32 logits (..., V)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return logz - gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean token-level NLL over masked positions. logits f32 (..., V)."""
    nll = token_nll(logits, labels) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)
