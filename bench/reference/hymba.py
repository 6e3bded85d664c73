"""Plain PyTorch Hymba (hybrid GQA attention + Mamba heads), computed in
float32, to hold the program's training steps and served tokens against.

It imports nothing of the program.  It follows the published design as
the configuration file states it (see ``configs/hymba-1.5b.json``,
``assumed``): per layer, RMSNorm, then in parallel GQA attention (RoPE;
a sliding window except in the full-attention layers) and a Mamba-1
mixer (in_proj to x and z, a causal depthwise conv, the selective scan
over a (d_inner, d_state) state, D skip, z gate, out_proj); each
branch's output RMS-normed and the two averaged into the residual;
RMSNorm and a SwiGLU MLP; a final RMSNorm and an untied output head.

The weights are laid out as the program takes them (``init_params``:
a tree of stacked leaves, one stack per run of layers of one window),
drawn here from the seed, so both sides get the same numbers.  Every
matrix product runs in float32 with TF32 off.  ``quant="fp8"`` rounds
both operands of every linear layer's product to float8 (e4m3, one
scale a tensor), the control.

Bucketed serving: a prompt left-padded to its bucket has its pad keys
masked and its RoPE positions counted from the first real token; a pad
position's query, whose every key is masked, averages the values of the
whole bucket (what a softmax over equally masked keys gives), and the
Mamba scan runs over the pad tokens as over any other.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]
FP8_MAX = 448.0


# ------------------------------------------------------------- layout
def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["d_model"]
    return {"d": d, "h": cfg["n_heads"], "kv": cfg["n_kv_heads"],
            "hd": cfg["head_dim"], "ff": cfg["d_ff"],
            "di": cfg["ssm_expand"] * d, "st": cfg["ssm_d_state"],
            "dc": cfg["ssm_d_conv"], "dr": -(-d // 16),
            "V": cfg["vocab_size"], "Vp": -(-cfg["vocab_size"] // 256) * 256}


def segments(cfg: Dict) -> List[Tuple[int, int]]:
    """(layers, window) of each run of consecutive layers of one window
    (0: full attention)."""
    full = set(cfg["full_attn_layers"])
    wins = [0 if i in full else cfg["sliding_window"]
            for i in range(cfg["n_layers"])]
    out: List[Tuple[int, int]] = []
    for w in wins:
        if out and out[-1][1] == w:
            out[-1] = (out[-1][0] + 1, w)
        else:
            out.append((1, w))
    return out


def _normal_leaves(cfg: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, std) of every normally drawn leaf, in draw order."""
    m = dims(cfg)
    d, h, kv, hd, ff = m["d"], m["h"], m["kv"], m["hd"], m["ff"]
    di, st, dc, dr = m["di"], m["st"], m["dc"], m["dr"]
    out = [(("embed",), (m["Vp"], d), 0.02),
           (("lm_head",), (m["Vp"], d), d ** -0.5)]
    for s, (n, _) in enumerate(segments(cfg)):
        seg = ("segments", s)
        out += [
            (seg + ("attn", "wq"), (n, d, h, hd), d ** -0.5),
            (seg + ("attn", "wk"), (n, d, kv, hd), d ** -0.5),
            (seg + ("attn", "wv"), (n, d, kv, hd), d ** -0.5),
            (seg + ("attn", "wo"), (n, h, hd, d), (h * hd) ** -0.5),
            (seg + ("ssm", "in_proj"), (n, d, 2 * di), d ** -0.5),
            (seg + ("ssm", "conv_w"), (n, dc, di), dc ** -0.5),
            (seg + ("ssm", "x_proj"), (n, di, dr + 2 * st), di ** -0.5),
            (seg + ("ssm", "dt_proj"), (n, dr, di), dr ** -0.5),
            (seg + ("ssm", "out_proj"), (n, di, d), di ** -0.5),
            (seg + ("mlp", "w_gate"), (n, d, ff), d ** -0.5),
            (seg + ("mlp", "w_up"), (n, d, ff), d ** -0.5),
            (seg + ("mlp", "w_down"), (n, ff, d), ff ** -0.5),
        ]
    return out


def _put(tree: Params, path: Tuple, leaf) -> None:
    node = tree
    for k in path[:-1]:
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if k == "segments" else {})
    node[path[-1]] = leaf


def init_params(cfg: Dict, seed: int, device) -> Params:
    """The weights, drawn on `device` from `seed`: the matrices in one
    normal draw in the configuration's dtype (each scaled by its own
    std), the conv bias 0 in that dtype; norms' scales 1, dt_bias
    softplus^-1(0.01), A_log log(1..d_state) and D 1 in float32, as the
    program keeps them."""
    m = dims(cfg)
    dtype = getattr(torch, cfg["dtype"])
    leaves = _normal_leaves(cfg)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Params = {}
    off = 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        _put(tree, path, flat[off:off + n].view(shape).mul_(std))
        off += n
    f32 = dict(dtype=torch.float32, device=device)
    _put(tree, ("final_norm", "scale"), torch.ones(m["d"], **f32))
    di, st, d = m["di"], m["st"], m["d"]
    for s, (n, _) in enumerate(segments(cfg)):
        seg = ("segments", s)
        for ln in ("ln1", "ln2", "ln_attn_out", "ln_ssm_out"):
            _put(tree, seg + (ln, "scale"), torch.ones(n, d, **f32))
        _put(tree, seg + ("ssm", "conv_b"),
             torch.zeros(n, di, dtype=dtype, device=device))
        _put(tree, seg + ("ssm", "dt_bias"),
             torch.full((n, di), math.log(math.expm1(0.01)), **f32))
        _put(tree, seg + ("ssm", "A_log"), torch.log(
            torch.arange(1, st + 1, **f32)).repeat(n, di, 1))
        _put(tree, seg + ("ssm", "D"), torch.ones(n, di, **f32))
    return tree


def leaves(tree: Any, prefix: Tuple = ()):
    """(path, leaf) in sorted-key order (dict keys sorted, lists in
    order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def path_name(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


# ------------------------------------------------------------- pieces
def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (amax / 448), in x's
    dtype; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, eq: str,
           quant: Optional[str]) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    return torch.einsum(eq, x, w)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head by pos * theta^(-i / half)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Scan(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over dim 1 of (B, S, di,
    st); returns every h_t.  Backward: g_t = dh_t + a_{t+1} g_{t+1},
    da_t = g_t h_{t-1}, db_t = g_t."""

    @staticmethod
    def forward(ctx, a, b):
        H = torch.empty_like(b)
        prev = torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            torch.addcmul(b[:, t], a[:, t], prev, out=H[:, t])
            prev = H[:, t]
        ctx.save_for_backward(a, H)
        return H

    @staticmethod
    def backward(ctx, dH):
        a, H = ctx.saved_tensors
        G = torch.empty_like(dH)
        S = dH.shape[1]
        G[:, S - 1] = dH[:, S - 1]
        for t in range(S - 2, -1, -1):
            torch.addcmul(dH[:, t], a[:, t + 1], G[:, t + 1], out=G[:, t])
        da = torch.zeros_like(G)
        da[:, 1:] = G[:, 1:] * H[:, :-1]
        return da, G


def attention(cfg: Dict, p: Params, h: torch.Tensor, pos: torch.Tensor,
              window: int, pad: int, bucket: int,
              quant: Optional[str]) -> torch.Tensor:
    m = dims(cfg)
    q = linear(h, p["wq"], "bsd,dhk->bshk", quant)
    k = linear(h, p["wk"], "bsd,dhk->bshk", quant)
    v = linear(h, p["wv"], "bsd,dhk->bshk", quant)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    g = m["h"] // m["kv"]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    S = h.shape[1]
    i = torch.arange(S, device=h.device)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] >= pad)
    if window:
        ok &= (i[:, None] - i[None, :]) < window
    if pad:       # a pad query averages the bucket's values
        ok[:pad] = i[None, :] < bucket
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * m["hd"] ** -0.5
    if pad:
        s[:, :, :pad] = 0.0
    w = torch.softmax(s.masked_fill(~ok, -math.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return linear(o, p["wo"], "bshk,hkd->bsd", quant)


def mamba(cfg: Dict, p: Params, h: torch.Tensor,
          quant: Optional[str]) -> torch.Tensor:
    m = dims(cfg)
    di, st, dc, dr = m["di"], m["st"], m["dc"], m["dr"]
    xz = linear(h, p["in_proj"], "bsd,de->bse", quant)
    x1, z = xz[..., :di], xz[..., di:]
    cw = p["conv_w"].float()
    conv = p["conv_b"].float() + x1 * cw[dc - 1]
    for i in range(1, dc):
        conv = conv + F.pad(x1[:, :-i], (0, 0, i, 0)) * cw[dc - 1 - i]
    x1 = F.silu(conv)
    proj = linear(x1, p["x_proj"], "bsi,ie->bse", quant)
    dt_raw, Bc, Cc = proj[..., :dr], proj[..., dr:dr + st], proj[..., dr + st:]
    dt = F.softplus(linear(dt_raw, p["dt_proj"], "bsr,ri->bsi", quant)
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)
    b = (dt * x1)[..., None] * Bc[:, :, None, :]
    H = Scan.apply(a, b)
    y = torch.einsum("bsin,bsn->bsi", H, Cc) + p["D"] * x1
    y = y * F.silu(z)
    return linear(y, p["out_proj"], "bsi,id->bsd", quant)


def block(cfg: Dict, p: Params, x: torch.Tensor, pos: torch.Tensor,
          window: int, pad: int, bucket: int,
          quant: Optional[str]) -> torch.Tensor:
    eps = cfg["norm_eps"]
    h = rmsnorm(p["ln1"]["scale"], x, eps)
    a = attention(cfg, p["attn"], h, pos, window, pad, bucket, quant)
    s = mamba(cfg, p["ssm"], h, quant)
    x = x + 0.5 * (rmsnorm(p["ln_attn_out"]["scale"], a, eps)
                   + rmsnorm(p["ln_ssm_out"]["scale"], s, eps))
    h = rmsnorm(p["ln2"]["scale"], x, eps)
    mp = p["mlp"]
    g = linear(h, mp["w_gate"], "bsd,df->bsf", quant)
    u = linear(h, mp["w_up"], "bsd,df->bsf", quant)
    return x + linear(F.silu(g) * u, mp["w_down"], "bsf,fd->bsd", quant)


def layer_params(P: Params, s: int, j: int) -> Params:
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[j]
    return take(P["segments"][s])


def hidden(cfg: Dict, P: Params, tokens: torch.Tensor, *, pad: int = 0,
           bucket: int = 0, quant: Optional[str] = None,
           remat: bool = False) -> torch.Tensor:
    """Final hidden states (after the final norm), (B, S, d) float32.
    Positions count from the first real token (`pad` pad tokens lead)."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device) - pad
    x = P["embed"][tokens.long()].float()
    for s, (n, window) in enumerate(segments(cfg)):
        for j in range(n):
            lp = layer_params(P, s, j)
            if remat:
                x = checkpoint(block, cfg, lp, x, pos, window, pad, bucket,
                               quant, use_reentrant=False)
            else:
                x = block(cfg, lp, x, pos, window, pad, bucket, quant)
    return rmsnorm(P["final_norm"]["scale"], x, cfg["norm_eps"])


def logits(cfg: Dict, P: Params, x: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """(…, vocab) float32 over the real vocabulary."""
    V = dims(cfg)["V"]
    return linear(x, P["lm_head"][:V], "bsd,vd->bsv", quant)
