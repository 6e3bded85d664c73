"""Attention layers: GQA (full / sliding-window / chunked online-softmax)
and MLA.

The port of ``repro.models.layers.attention``, in plain PyTorch with the
reference's cast points: f32 logits, softmax weights cast to ``v``'s
dtype, the chunked path's running max, denominator and accumulator in
f32.  One exception, on the CPU only: there the softmax denominator and
the decode PV product are summed in f64 (see :func:`_exact_sums`).  It
uses explicit products and softmax, not a fused attention call and not
the flash-attention kernel (``kernels/flash_attention``): that kernel
has no ``k_valid`` pad mask, and a padded prompt must prefill like its
unpadded form.

Decode writes the new key/value (or MLA latent) into the cache in place
and returns the same buffers: the caller's cache holds the new values.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .common import apply_rope, normal_init, rmsnorm, rope_angles

Params = Dict[str, Any]

CHUNK_THRESHOLD = 2048  # use chunked attention above this sequence length
Q_CHUNK = 1024
KV_CHUNK = 1024
NEG_INF = -1e30


# =================================================================== GQA
def init_gqa(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = cfg.param_dtype
    s = d ** -0.5
    return {
        "wq": normal_init(gen, (*lead, d, h, hd), dt, s),
        "wk": normal_init(gen, (*lead, d, kv, hd), dt, s),
        "wv": normal_init(gen, (*lead, d, kv, hd), dt, s),
        "wo": normal_init(gen, (*lead, h, hd, d), dt, (h * hd) ** -0.5),
    }


def _repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, kv, hd) -> (B, S, n_heads, hd)."""
    kv = x.shape[2]
    if kv == n_heads:
        return x
    return torch.repeat_interleave(x, n_heads // kv, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int, k_valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(Sq, Sk) additive f32 bias from absolute positions."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid is not None:
        ok &= k_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _exact_sums(t: torch.Tensor) -> bool:
    """Whether the softmax denominator and the decode PV product sum in
    f64: on the CPU only.  There PyTorch's f32 reductions round by the
    row's length and by where its zeros fall, so a left-padded prompt
    would not prefill and decode bit for bit like its unpadded form; the
    f64 sums, exact or nearly so, restore that.  On the card the products
    that feed the softmax already round by shape, so f64 would not buy
    the identity there: the card keeps the reference's f32 sums."""
    return t.device.type == "cpu"


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, as ``jax.nn.softmax`` computes it (the
    denominator in f64 on the CPU, see :func:`_exact_sums`)."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    if _exact_sums(e):
        return e / e.sum(dim=-1, keepdim=True,
                         dtype=torch.float64).to(e.dtype)
    return e / e.sum(dim=-1, keepdim=True)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
         window: int = 0, k_valid: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """Full-materialization attention. q: (B,Sq,H,hd), k/v: (B,Sk,H,hd)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * (hd ** -0.5) + _mask_bias(q_pos, k_pos, causal,
                                                window, k_valid)
    w = _softmax(logits).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                 window: int = 0, k_valid: Optional[torch.Tensor] = None,
                 q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK
                 ) -> torch.Tensor:
    """Online-softmax chunked attention; memory O(q_chunk * kv_chunk).

    Block-masked like the reference: every (q chunk, kv chunk) pair is
    computed, fully masked ones included.  Where autograd records, each
    (q chunk, kv chunk) step runs under ``torch.utils.checkpoint``, so
    backward recomputes its score block instead of keeping it (the
    reference's ``@jax.checkpoint kv_step``).
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0, (Sq, Sk, q_chunk,
                                                      kv_chunk)
    scale = hd ** -0.5

    def kv_step(m, l, acc, qi, ki, vi, qpi, kpi, kvi):
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, ki).float()
        logits = logits * scale + _mask_bias(qpi, kpi, causal, window, kvi)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None].transpose(1, 2) + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(vi.dtype), vi).float()
        return m_new, l, acc

    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi, qpi = q[:, qs], q_pos[qs]
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, q_chunk, H, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            args = (m, l, acc, qi, k[:, ks], v[:, ks], qpi, k_pos[ks],
                    None if k_valid is None else k_valid[ks])
            m, l, acc = (checkpoint(kv_step, *args, use_reentrant=False)
                         if remat else kv_step(*args))
        out = acc / l.clamp_min(1e-30)[..., None].transpose(1, 2)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def gqa_forward(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                k_valid: Optional[torch.Tensor] = None, tp=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train/prefill). Returns (out, kv-cache).

    kv_override supplies (k, v) already projected — used by cross-attention.
    k_valid is an (S,) bool key-validity mask: False keys (e.g. left-pad
    slots in bucketed serving prefill) are never attended.

    With `tp` (a model-axis group) ``wq`` and ``wo`` are this rank's
    heads; ``wk``/``wv`` are its kv heads when the model axis divides
    them, else whole (the plan leaves them unsharded), and the rank takes
    the kv head of each of its query heads.  One all-reduce sums the
    heads' outputs.
    """
    h = cfg.n_heads
    wk, wv = p["wk"], p["wv"]
    if tp is not None:
        x = tp.copy_in(x)
        h = h // tp.size
        if wk.shape[1] == cfg.n_kv_heads:  # wk, wv whole: pick per head
            group = cfg.n_heads // cfg.n_kv_heads
            idx = (tp.rank * h + torch.arange(h, device=x.device)) // group
            wk, wv = wk.index_select(1, idx), wv.index_select(1, idx)
    S = x.shape[1]      # after copy_in: the whole sequence
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, wk)
        v = torch.einsum("bsd,dhk->bshk", x, wv)
        cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv_override
    cache = {"k": k, "v": v}
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    k_pos = positions if kv_override is None else torch.arange(
        k.shape[1], device=x.device)
    if max(S, k.shape[1]) > CHUNK_THRESHOLD:
        out = chunked_sdpa(q, kf, vf, positions, k_pos, causal=causal,
                           window=window, k_valid=k_valid)
    else:
        out = sdpa(q, kf, vf, positions, k_pos, causal=causal, window=window,
                   k_valid=k_valid)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return (out if tp is None else tp.reduce_out(out)), cache


def _write_slot(buf: torch.Tensor, val: torch.Tensor, slot: torch.Tensor
                ) -> torch.Tensor:
    """buf[b, slot[b]] = val[b, 0] for every row b, in place."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot] = val[:, 0]
    return buf


def gqa_decode(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, *, window: int = 0, cross: bool = False,
               start: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B,1,d); cache k/v: (B,Sc,kv,hd); pos: (B,).

    For sliding-window layers the cache is a ring buffer of size `window`.
    For cross-attention the cache holds encoder k/v and is not updated.
    start (B,) marks the first real cache position per row (left-pad count
    from bucketed prefill): slots below it are never attended, and RoPE
    runs at pad-relative positions (pos - start) so a padded prompt decodes
    bit-identically to its unpadded form.  The new k/v are written into
    the cache's buffers in place.
    """
    B = x.shape[0]
    h = cfg.n_heads
    Sc = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])

    if not cross:
        k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        rpos = pos if start is None else pos - start
        cos, sin = rope_angles(rpos[:, None], cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        slot = (pos % Sc).long()
        cache = {"k": _write_slot(cache["k"], k_new, slot),
                 "v": _write_slot(cache["v"], v_new, slot)}

    # grouped-query form, no repeat-kv (as the reference, which keeps the
    # sequence-sharded cache in place)
    kv_heads = cache["k"].shape[2]
    g = h // kv_heads
    qg = q.reshape(B, kv_heads, g, cfg.head_dim_)      # (B,kv,g,hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, cache["k"]).float()
    logits = logits * (cfg.head_dim_ ** -0.5)
    if not cross:
        slots = torch.arange(Sc, device=x.device)
        if window:
            valid = (slots[None, :] < pos[:, None]) | (pos[:, None] >= Sc)
            if start is not None:
                # absolute position held by ring-buffer slot s
                abs_pos = pos[:, None] - torch.remainder(
                    pos[:, None] - slots[None, :], Sc)
                valid &= abs_pos >= start[:, None]
        else:
            valid = slots[None, :] <= pos[:, None]
            if start is not None:
                valid &= slots[None, :] >= start[:, None]
        logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = _softmax(logits).to(cache["v"].dtype)
    if _exact_sums(w):
        # with one query head a group the product is a matrix-vector one,
        # whose f32 sum order on the CPU follows where the real slots sit
        out = torch.einsum("bkgs,bskd->bkgd", w.double(),
                           cache["v"].double()).to(cache["v"].dtype)
    else:
        out = torch.einsum("bkgs,bskd->bkgd", w, cache["v"])
    out = out.reshape(B, 1, h, cfg.head_dim_)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


# =================================================================== MLA
def init_mla(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    return {
        "w_dq": normal_init(gen, (*lead, d, qr), dt, d ** -0.5),
        "w_uq": normal_init(gen, (*lead, qr, h, nope + rope), dt, qr ** -0.5),
        "w_dkv": normal_init(gen, (*lead, d, kvr + rope), dt, d ** -0.5),
        "w_uk": normal_init(gen, (*lead, kvr, h, nope), dt, kvr ** -0.5),
        "w_uv": normal_init(gen, (*lead, kvr, h, vh), dt, kvr ** -0.5),
        "wo": normal_init(gen, (*lead, h, vh, d), dt, (h * vh) ** -0.5),
        "q_norm": torch.ones((*lead, qr), device=gen.device),
        "kv_norm": torch.ones((*lead, kvr), device=gen.device),
    }


def _mla_q(cfg, p, x, positions):
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = rmsnorm({"scale": p["q_norm"]}, x @ p["w_dq"])
    q = torch.einsum("bsr,rhk->bshk", q_lat, p["w_uq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_angles(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_latent(cfg, p, x, positions):
    kvr = cfg.kv_lora_rank
    lat = x @ p["w_dkv"]
    ckv = rmsnorm({"scale": p["kv_norm"]}, lat[..., :kvr])
    k_rope = lat[..., kvr:][:, :, None, :]  # single shared rope head
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0, :]
    return ckv, k_rope


def mla_forward(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
                k_valid: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train/prefill MLA with naive (expanded) K/V; latent cache returned."""
    B, S, _ = x.shape
    vh = cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    h = cfg.n_heads
    k_rope_b = k_rope[:, :, None, :].expand(B, S, h, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    # pad v to qk dim for the shared chunked path, then slice back
    if S > CHUNK_THRESHOLD:
        vp = torch.nn.functional.pad(v, (0, q.shape[-1] - vh))
        out = chunked_sdpa(q, k, vp, positions, positions, causal=True,
                           k_valid=k_valid)[..., :vh]
    else:
        out = sdpa(q, k, v, positions, positions, causal=True,
                   k_valid=k_valid)
    cache = {"ckv": ckv, "k_rope": k_rope}
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def mla_decode(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, start: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed MLA decode: attention runs in the latent space.

    score(t) = q_nope^T W_uk ckv_t + q_rope . k_rope_t
    out      = (sum_t w_t ckv_t) W_uv

    start (B,): first real cache slot per row (see gqa_decode).  The new
    latent is written into the cache's buffers in place.
    """
    Sc = cache["ckv"].shape[1]
    rpos = pos if start is None else pos - start
    q_nope, q_rope = _mla_q(cfg, p, x, rpos[:, None])
    ckv_new, k_rope_new = _mla_latent(cfg, p, x, rpos[:, None])
    slot = (pos % Sc).long()
    cache = {"ckv": _write_slot(cache["ckv"], ckv_new, slot),
             "k_rope": _write_slot(cache["k_rope"], k_rope_new, slot)}
    # absorb: q_lat (B,1,h,kvr)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    logits = torch.einsum("bshr,btr->bhst", q_lat, cache["ckv"]).float()
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope,
                                   cache["k_rope"]).float()
    logits = logits * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    slots = torch.arange(Sc, device=x.device)
    valid = slots[None, :] <= pos[:, None]
    if start is not None:
        valid &= slots[None, :] >= start[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = _softmax(logits)
    o_lat = torch.einsum("bhst,btr->bshr", w.to(cache["ckv"].dtype),
                         cache["ckv"])
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache
