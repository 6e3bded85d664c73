"""Plain PyTorch DeepSeek-V2 (MLA without query compression, YaRN RoPE,
a leading dense SwiGLU layer, then MoE layers with shared experts),
computed in float32, to hold the program's training steps against.

It imports nothing of the program.  It follows the published modeling
code as the configuration file states it (``configs/deepseek-v2-lite.json``,
``assumed``).  Per layer, RMSNorm then MLA: q = x W_q split into a
no-position part (qk_nope) and a rotated part (qk_rope); the latent
[c, k_r] = x W_dkv, c RMS-normed, keys [c W_uk, rope(k_r)] (one rotated
key shared by the heads), values c W_uv; causal softmax attention with
the scale qk_dim^-0.5 times yarn_mscale(factor, mscale_all_dim)^2;
the heads' outputs through W_o.  RoPE is YaRN's: inverse frequencies
1 / (factor theta^(2i/r)) below the correction range of beta_fast and
beta_slow rotations over the original positions, 1 / theta^(2i/r) above
it, a linear ramp between, cos and sin times yarn_mscale(factor,
mscale) / yarn_mscale(factor, mscale_all_dim); the rotated dims in the
half-split layout.  Then RMSNorm and either a SwiGLU MLP (the first
``first_k_dense_replace`` layers) or the MoE layer: softmax over the
router's logits (float32) for all n_routed experts, the greedy top-k,
their probabilities (renormalised only with ``norm_topk_prob``; the
published ``routed_scaling_factor`` is 1); the output is the weighted
SwiGLU of each token's top-k experts among the experts held, ``[0,
held)``, a plain loop over them, plus the shared experts (one SwiGLU of n_shared widths).  The
balance loss, per sequence: n_routed times the sum over experts of the
sequence's mean probability and its share of the top-k picks (counts
over S k), averaged over the sequences, summed over the MoE layers.

The weights are laid out as the program takes them (its tree of stacked
leaves: one stack for the dense layer, one for the MoE layers), drawn
from the seed: the matrices in one normal draw in the configuration's
dtype, the router in one float32 draw, norms 1.  Every matrix product
runs in float32 with TF32 off (``train_deepseek.steps``).

``fault`` (the controls of the check): ``fp8`` rounds both operands of
every linear layer to float8; ``renorm`` renormalises the top-k
probabilities; ``no_mscale`` leaves YaRN's softmax factor out;
``drop_expert`` drops held expert 0's rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .hymba import _put, leaves, linear, path_name, rmsnorm  # noqa: F401

Params = Dict[str, Any]
FAULTS = ("fp8", "renorm", "no_mscale", "drop_expert")


def dims(cfg: Dict) -> Dict[str, int]:
    if cfg.get("q_lora_rank"):
        raise NotImplementedError("deepseek_v2: query compression")
    e = cfg["moe_n_routed"]
    return {"d": cfg["d_model"], "h": cfg["n_heads"],
            "nope": cfg["qk_nope_dim"], "rope": cfg["qk_rope_dim"],
            "vh": cfg["v_head_dim"], "kvr": cfg["kv_lora_rank"],
            "ff": cfg["dense_d_ff"], "f": cfg["moe_d_ff"],
            "sf": cfg["moe_n_shared"] * cfg["moe_d_ff"], "E": e,
            "Ep": -(-e // 16) * 16, "held": cfg.get("moe_experts_held") or e,
            "k": cfg["moe_top_k"], "dense": cfg["moe_first_k_dense"],
            "L": cfg["n_layers"], "V": cfg["vocab_size"],
            "Vp": -(-cfg["vocab_size"] // 256) * 256}


def segments(cfg: Dict) -> List[Tuple[int, bool]]:
    """(layers, is MoE) of each stack of layers."""
    m = dims(cfg)
    out = [(m["dense"], False)] if m["dense"] else []
    return out + [(m["L"] - m["dense"], True)]


def _normal_leaves(cfg: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf drawn in the configuration's
    dtype, in draw order."""
    m = dims(cfg)
    d, h, nope, rope, vh, kvr = (m["d"], m["h"], m["nope"], m["rope"],
                                 m["vh"], m["kvr"])
    out = [(("embed",), (m["Vp"], d), 0.02),
           (("lm_head",), (m["Vp"], d), d ** -0.5)]
    for s, (n, moe) in enumerate(segments(cfg)):
        seg = ("segments", s)
        out += [
            (seg + ("attn", "w_q"), (n, d, h, nope + rope), d ** -0.5),
            (seg + ("attn", "w_dkv"), (n, d, kvr + rope), d ** -0.5),
            (seg + ("attn", "w_uk"), (n, kvr, h, nope), kvr ** -0.5),
            (seg + ("attn", "w_uv"), (n, kvr, h, vh), kvr ** -0.5),
            (seg + ("attn", "wo"), (n, h, vh, d), (h * vh) ** -0.5)]
        if not moe:
            ff = m["ff"]
            out += [(seg + ("mlp", "w_gate"), (n, d, ff), d ** -0.5),
                    (seg + ("mlp", "w_up"), (n, d, ff), d ** -0.5),
                    (seg + ("mlp", "w_down"), (n, ff, d), ff ** -0.5)]
            continue
        f, sf, held = m["f"], m["sf"], m["held"]
        out += [(seg + ("moe", "w_gate"), (n, held, d, f), d ** -0.5),
                (seg + ("moe", "w_up"), (n, held, d, f), d ** -0.5),
                (seg + ("moe", "w_down"), (n, held, f, d), f ** -0.5),
                (seg + ("moe", "shared", "w_gate"), (n, d, sf), d ** -0.5),
                (seg + ("moe", "shared", "w_up"), (n, d, sf), d ** -0.5),
                (seg + ("moe", "shared", "w_down"), (n, sf, d), sf ** -0.5)]
    return out


def init_params(cfg: Dict, seed: int, device) -> Params:
    """The weights, drawn on `device` from `seed` (module docstring)."""
    m = dims(cfg)
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: Params = {}
    for draw_dtype, group in ((dtype, _normal_leaves(cfg)),
                              (torch.float32, [
                                  (("segments", s, "moe", "router"),
                                   (n, m["d"], m["Ep"]), m["d"] ** -0.5)
                                  for s, (n, moe) in enumerate(segments(cfg))
                                  if moe])):
        total = sum(math.prod(shape) for _, shape, _ in group)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=draw_dtype)
        off = 0
        for path, shape, std in group:
            size = math.prod(shape)
            _put(tree, path, flat[off:off + size].view(shape).mul_(std))
            off += size
    f32 = dict(dtype=torch.float32, device=device)
    _put(tree, ("final_norm", "scale"), torch.ones(m["d"], **f32))
    for s, (n, _) in enumerate(segments(cfg)):
        seg = ("segments", s)
        for ln in ("ln1", "ln2"):
            _put(tree, seg + (ln, "scale"), torch.ones(n, m["d"], **f32))
        _put(tree, seg + ("attn", "kv_norm"), torch.ones(n, m["kvr"], **f32))
    return tree


# ------------------------------------------------------------- pieces
def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_tables(cfg: Dict, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (S, rope / 2) of YaRN RoPE at positions `pos`, as the
    published ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    dim, base = cfg["qk_rope_dim"], cfg["rope_theta"]
    factor, orig, beta_fast, beta_slow, mscale, mscale_all = cfg["rope_yarn"]
    ex = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    freq_extra = 1.0 / (base ** ex)
    freq_inter = 1.0 / (factor * base ** ex)

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=pos.device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    ang = pos.float()[:, None] * inv_freq[None, :]
    scale = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate (B, S, H, r) in the half-split layout."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def softmax_scale(cfg: Dict, fault: Optional[str]) -> float:
    scale = (cfg["qk_nope_dim"] + cfg["qk_rope_dim"]) ** -0.5
    factor, mad = cfg["rope_yarn"][0], cfg["rope_yarn"][5]
    if mad and fault != "no_mscale":
        m = yarn_mscale(factor, mad)
        scale = scale * m * m
    return scale


def mla(cfg: Dict, p: Params, h: torch.Tensor, cos, sin,
        fault: Optional[str]) -> torch.Tensor:
    m = dims(cfg)
    quant = "fp8" if fault == "fp8" else None
    nope, kvr = m["nope"], m["kvr"]
    q = linear(h, p["w_q"], "bsd,dhk->bshk", quant)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    lat = linear(h, p["w_dkv"], "bsd,dr->bsr", quant)
    c = rmsnorm(p["kv_norm"], lat[..., :kvr], cfg["norm_eps"])
    k_r = rope(lat[..., None, kvr:], cos, sin)
    k_n = linear(c, p["w_uk"], "bsr,rhk->bshk", quant)
    v = linear(c, p["w_uv"], "bsr,rhk->bshk", quant)
    k = torch.cat([k_n, k_r.expand(-1, -1, m["h"], -1)], dim=-1)
    S = h.shape[1]
    i = torch.arange(S, device=h.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(cfg, fault)
    w = torch.softmax(s.masked_fill(i[None, :] > i[:, None], -math.inf), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return linear(o, p["wo"], "bshk,hkd->bsd", quant)


def swiglu(p: Params, h: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    g = linear(h, p["w_gate"], "...d,df->...f", quant)
    u = linear(h, p["w_up"], "...d,df->...f", quant)
    return linear(F.silu(g) * u, p["w_down"], "...f,fd->...d", quant)


def moe(cfg: Dict, p: Params, h: torch.Tensor, fault: Optional[str]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, balance loss of these sequences), h: (B, S, d)."""
    m = dims(cfg)
    quant = "fp8" if fault == "fp8" else None
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    logits = x @ p["router"].float()
    if m["Ep"] != m["E"]:
        logits[:, m["E"]:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, m["k"], dim=-1)
    if cfg["moe_norm_topk"] or fault == "renorm":
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m["held"]):
        if fault == "drop_expert" and e == 0:
            continue
        hit = top_i == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        wt = (top_p * hit).sum(-1)[rows]
        ep = {k: p[k][e] for k in ("w_gate", "w_up", "w_down")}
        out = out.index_add(0, rows, wt[:, None] * swiglu(ep, x[rows], quant))
    out = out + swiglu(p["shared"], x, quant)
    me = probs.reshape(B, S, -1).mean(1)[:, :m["E"]]
    ce = torch.zeros(B, m["Ep"], device=h.device).scatter_add_(
        1, top_i.reshape(B, -1), torch.ones(B, S * m["k"], device=h.device))
    ce = ce[:, :m["E"]] / (S * m["k"])
    aux = m["E"] * (me * ce).sum(-1).mean()
    return out.reshape(B, S, d), aux


def block(cfg: Dict, p: Params, x: torch.Tensor, cos, sin, is_moe: bool,
          fault: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    eps = cfg["norm_eps"]
    x = x + mla(cfg, p["attn"], rmsnorm(p["ln1"]["scale"], x, eps), cos, sin,
                fault)
    h = rmsnorm(p["ln2"]["scale"], x, eps)
    if not is_moe:
        return x + swiglu(p["mlp"], h, "fp8" if fault == "fp8" else None), \
            x.new_zeros(())
    y, aux = moe(cfg, p["moe"], h, fault)
    return x + y, aux


def layer_params(P: Params, s: int, j: int) -> Params:
    def take(t):
        if isinstance(t, dict):
            return {k: take(v) for k, v in t.items()}
        return t[j]
    return take(P["segments"][s])


def hidden(cfg: Dict, P: Params, tokens: torch.Tensor, *,
           fault: Optional[str] = None, remat: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d) float32 after the final norm, the
    balance loss summed over the MoE layers)."""
    S = tokens.shape[1]
    cos, sin = rope_tables(cfg, torch.arange(S, device=tokens.device))
    x = P["embed"][tokens.long()].float()
    aux = x.new_zeros(())
    for s, (n, is_moe) in enumerate(segments(cfg)):
        for j in range(n):
            args = (cfg, layer_params(P, s, j), x, cos, sin, is_moe, fault)
            x, a = (checkpoint(block, *args, use_reentrant=False) if remat
                    else block(*args))
            aux = aux + a
    return rmsnorm(P["final_norm"]["scale"], x, cfg["norm_eps"]), aux


def logits(cfg: Dict, P: Params, x: torch.Tensor,
           fault: Optional[str] = None) -> torch.Tensor:
    """(…, vocab) float32 over the real vocabulary."""
    return linear(x, P["lm_head"][:dims(cfg)["V"]], "...d,vd->...v",
                  "fp8" if fault == "fp8" else None)

