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

Sharded decode (``transformer.decode_step`` on DTensor params) passes the
rank's heads (``tp``), the model group and how the cache is split over
it (``layout``): "heads" (the rank's kv heads, the reference's layout
when they divide the model axis), "seq" (the rank's run of slots for
every head, flash-decode style: the softmax and the weighted values
are combined over the group, ``parallel.split_softmax``, and a new
key lands on the one rank that owns its slot) or None (whole).  The
masks keep global slot indices, so ring buffers, ``window``, ``start``
and cross-attention read the same slots as on one device.  MLA splits
its heads the same way; its latent cache has no heads, so it is split
on the sequence or whole (:func:`mla_decode`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import parallel
from .common import (apply_rope, normal_init, rmsnorm, rope_angles,
                     yarn_mscale)

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


def _softmax(logits: torch.Tensor, seq=None) -> torch.Tensor:
    """Softmax over the last axis, as ``jax.nn.softmax`` computes it (the
    denominator in f64 on the CPU, see :func:`_exact_sums`); with `seq`
    (a group over which the last axis is split) this rank's part of it."""
    if seq is not None:
        return parallel.split_softmax(logits, seq, _exact_sums(logits))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    if _exact_sums(e):
        return e / e.sum(dim=-1, keepdim=True,
                         dtype=torch.float64).to(e.dtype)
    return e / e.sum(dim=-1, keepdim=True)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
         window: int = 0, k_valid: Optional[torch.Tensor] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """Full-materialization attention. q: (B,Sq,H,hd), k/v: (B,Sk,H,hd).
    `scale` multiplies the logits (default ``hd ** -0.5``)."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    logits = logits * (hd ** -0.5 if scale is None else scale) + _mask_bias(
        q_pos, k_pos, causal, window, k_valid)
    w = _softmax(logits).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                 window: int = 0, k_valid: Optional[torch.Tensor] = None,
                 q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax chunked attention; memory O(q_chunk * kv_chunk).
    `scale` multiplies the logits (default ``hd ** -0.5``).

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
    scale = hd ** -0.5 if scale is None else scale

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


def _chunk_args(cfg, sq: int, sk: int) -> Dict[str, int]:
    """``chunked_sdpa``'s block sizes from ``cfg.attn_chunks``, each at
    most its sequence; none where the configuration keeps the defaults."""
    if not cfg.attn_chunks:
        return {}
    qc, kc = cfg.attn_chunks
    return {"q_chunk": min(qc, sq), "kv_chunk": min(kc, sk)}


def gqa_forward(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                causal: bool = True, window: int = 0,
                kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                k_valid: Optional[torch.Tensor] = None, tp=None,
                whole_kv: bool = False,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention (train/prefill). Returns (out, kv-cache).

    kv_override supplies (k, v) already projected — used by cross-attention.
    k_valid is an (S,) bool key-validity mask: False keys (e.g. left-pad
    slots in bucketed serving prefill) are never attended.

    With `tp` (a model-axis group) ``wq`` and ``wo`` are this rank's
    heads; ``wk``/``wv`` are its kv heads when the model axis divides
    them, else whole (the plan leaves them unsharded), and the rank takes
    the kv head of each of its query heads (with `whole_kv` it projects
    every kv head and the cache holds them all: a sharded prefill then
    splits that cache on the sequence).  A `kv_override` was projected
    with those ``wk``/``wv``: the rank's kv heads, or every kv head, of
    which it takes its query heads' as `whole_kv` does.  One all-reduce
    sums the heads' outputs.
    """
    h = cfg.n_heads
    wk, wv = p["wk"], p["wv"]
    idx = None
    if tp is not None:
        x = tp.copy_in(x)
        h = h // tp.size
        if wk.shape[1] == cfg.n_kv_heads:  # wk, wv whole: pick per head
            group = cfg.n_heads // cfg.n_kv_heads
            idx = (tp.rank * h + torch.arange(h, device=x.device)) // group
            if not whole_kv:
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
    if idx is not None and (whole_kv or kv_override is not None):
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    k_pos = positions if kv_override is None else torch.arange(
        k.shape[1], device=x.device)
    if max(S, k.shape[1]) > CHUNK_THRESHOLD:
        out = chunked_sdpa(q, kf, vf, positions, k_pos, causal=causal,
                           window=window, k_valid=k_valid,
                           **_chunk_args(cfg, S, k.shape[1]))
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
               start: Optional[torch.Tensor] = None, tp=None, model=None,
               layout: Optional[str] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B,1,d); cache k/v: (B,Sc,kv,hd); pos: (B,).

    For sliding-window layers the cache is a ring buffer of size `window`.
    For cross-attention the cache holds encoder k/v and is not updated.
    start (B,) marks the first real cache position per row (left-pad count
    from bucketed prefill): slots below it are never attended, and RoPE
    runs at pad-relative positions (pos - start) so a padded prompt decodes
    bit-identically to its unpadded form.  The new k/v are written into
    the cache's buffers in place.

    Sharded (see the module docstring): `tp` is the heads' group (``wq``
    and ``wo`` are the rank's heads; ``wk``/``wv`` its kv heads on a
    "heads" cache, else whole), `model` the model group and `layout` the
    cache's split over it.  On a "heads" cache the rank attends with its
    heads to its kv heads' history.  Otherwise a rank with `tp` gathers
    every head's query over it (a few hundred bytes a row), attends with
    all heads to its slots, and keeps its heads' outputs (on a "seq"
    cache one reduce-scatter on the heads, :func:`_own_heads`).  The
    heads' outputs are summed over `tp`.
    """
    B = x.shape[0]
    hd = cfg.head_dim_
    wq, wo = p["wq"], p["wo"]
    seq = model if layout == "seq" else None
    Sc = cache["k"].shape[1]                 # this rank's slots
    offset = 0 if seq is None else seq.rank * Sc
    n_slots = Sc if seq is None else Sc * seq.size
    q = torch.einsum("bsd,dhk->bshk", x, wq)

    if not cross:
        k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        rpos = pos if start is None else pos - start
        cos, sin = rope_angles(rpos[:, None], hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        slot = (pos % n_slots).long()
        if seq is None:
            cache = {"k": _write_slot(cache["k"], k_new, slot),
                     "v": _write_slot(cache["v"], v_new, slot)}
        else:
            cache = {"k": parallel.write_owned(cache["k"], k_new, slot,
                                               offset),
                     "v": parallel.write_owned(cache["v"], v_new, slot,
                                               offset)}
    mine = None
    if tp is not None and layout != "heads":
        mine = slice(tp.rank * q.shape[2], (tp.rank + 1) * q.shape[2])
        q = tp.all_gather(q, 2)
    h = q.shape[2]

    # grouped-query form, no repeat-kv (as the reference, which keeps the
    # sequence-sharded cache in place)
    kv_heads = cache["k"].shape[2]
    g = h // kv_heads
    qg = q.reshape(B, kv_heads, g, hd)      # (B,kv,g,hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, cache["k"]).float()
    logits = logits * (hd ** -0.5)
    if not cross:
        slots = torch.arange(offset, offset + Sc, device=x.device)
        if window:
            valid = (slots[None, :] < pos[:, None]) | (pos[:, None] >= n_slots)
            if start is not None:
                # absolute position held by ring-buffer slot s
                abs_pos = pos[:, None] - torch.remainder(
                    pos[:, None] - slots[None, :], n_slots)
                valid &= abs_pos >= start[:, None]
        else:
            valid = slots[None, :] <= pos[:, None]
            if start is not None:
                valid &= slots[None, :] >= start[:, None]
        logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = _softmax(logits, seq).to(cache["v"].dtype)
    if _exact_sums(w):
        # with one query head a group the product is a matrix-vector one,
        # whose f32 sum order on the CPU follows where the real slots sit
        out = torch.einsum("bkgs,bskd->bkgd", w.double(),
                           cache["v"].double())
    else:
        out = torch.einsum("bkgs,bskd->bkgd", w, cache["v"])
    out = _own_heads(out.reshape(B, 1, h, hd), seq, mine)
    out = torch.einsum("bshk,hkd->bsd", out.to(cache["v"].dtype), wo)
    return (out if tp is None else tp.reduce_out(out)), cache


def _own_heads(out: torch.Tensor, seq, mine: Optional[slice]
               ) -> torch.Tensor:
    """A decode step's per-head outputs (B, 1, h, ...) as this rank
    keeps them: summed over the cache's sequence group `seq` where it has
    one, and cut to the rank's heads `mine` where every head attended.
    Both at once are one reduce-scatter on the heads (decode runs
    outside autograd), moving 1/size of the all-reduce's sum."""
    if seq is not None and mine is not None:
        return parallel._scatter_dim(out, seq, 2)
    if seq is not None:
        out = seq.reduce_out(out)
    return out if mine is None else out[:, :, mine]


# =================================================================== MLA
def init_mla(cfg, gen: torch.Generator, lead: Tuple = ()) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    if qr:
        p = {"w_dq": normal_init(gen, (*lead, d, qr), dt, d ** -0.5),
             "w_uq": normal_init(gen, (*lead, qr, h, nope + rope), dt,
                                 qr ** -0.5)}
    else:   # no query compression: one projection to the heads
        p = {"w_q": normal_init(gen, (*lead, d, h, nope + rope), dt,
                                d ** -0.5)}
    p.update({
        "w_dkv": normal_init(gen, (*lead, d, kvr + rope), dt, d ** -0.5),
        "w_uk": normal_init(gen, (*lead, kvr, h, nope), dt, kvr ** -0.5),
        "w_uv": normal_init(gen, (*lead, kvr, h, vh), dt, kvr ** -0.5),
        "wo": normal_init(gen, (*lead, h, vh, d), dt, (h * vh) ** -0.5)})
    if qr:
        p["q_norm"] = torch.ones((*lead, qr), device=gen.device)
    p["kv_norm"] = torch.ones((*lead, kvr), device=gen.device)
    return p


def mla_scale(cfg) -> float:
    """MLA's softmax scale: ``(nope + rope) ** -0.5``, with YaRN and
    ``mscale_all_dim`` times ``yarn_mscale(factor, mscale_all_dim) ** 2``."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    yarn = cfg.rope_yarn
    if yarn and yarn[5]:
        m = yarn_mscale(yarn[0], yarn[5])
        scale = scale * m * m
    return scale


def _down(p, key: str, x: torch.Tensor, width: int, tp) -> torch.Tensor:
    """``x @ p[key]``, a latent of `width` columns.  With `tp` the weight
    may be this rank's block of columns (the plan splits it over the
    model axis): the blocks of the latent are then gathered over `tp`,
    an activation of B x S x width, where gathering the weight would
    move d x width."""
    lat = x @ p[key]
    if tp is not None and lat.shape[-1] != width:
        lat = tp.all_gather(lat, -1)
    return lat


def _mla_q(cfg, p, x, positions, tp=None):
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if "w_q" in p:
        q = torch.einsum("bsd,dhk->bshk", x, p["w_q"])
    else:
        q_lat = rmsnorm({"scale": p["q_norm"]},
                        _down(p, "w_dq", x, cfg.q_lora_rank, tp),
                        cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", q_lat, p["w_uq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = rope_angles(positions, rope, cfg.rope_theta, cfg.rope_yarn)
    q_rope = apply_rope(q_rope, cos, sin)
    return q_nope, q_rope


def _mla_latent(cfg, p, x, positions, tp=None):
    kvr = cfg.kv_lora_rank
    lat = _down(p, "w_dkv", x, kvr + cfg.qk_rope_dim, tp)
    ckv = rmsnorm({"scale": p["kv_norm"]}, lat[..., :kvr], cfg.norm_eps)
    k_rope = lat[..., kvr:][:, :, None, :]  # single shared rope head
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta,
                           cfg.rope_yarn)
    k_rope = apply_rope(k_rope, cos, sin)[:, :, 0, :]
    return ckv, k_rope


def mla_forward(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
                k_valid: Optional[torch.Tensor] = None, tp=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train/prefill MLA with naive (expanded) K/V; latent cache returned.

    With `tp` (a model-axis group) ``w_uq``, ``w_uk``, ``w_uv`` and
    ``wo`` are this rank's heads, and ``w_dq``/``w_dkv`` its blocks of
    the latents' columns where the plan splits them (else whole): the
    rank computes its columns of each latent and gathers the latent
    activation over `tp` (:func:`_down`; in training too, one path: the
    gather's gradient is reduce-scattered back to the columns), then
    normalizes it whole and expands its heads' keys and values from it,
    the shared rope key broadcast to them.  The latent cache is whole on
    every rank.  One all-reduce sums the heads' outputs.
    """
    h = cfg.n_heads
    if tp is not None:
        x = tp.copy_in(x)
        h //= tp.size
    B, S, _ = x.shape   # after copy_in: the whole sequence
    vh = cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x, positions, tp)
    ckv, k_rope = _mla_latent(cfg, p, x, positions, tp)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
    k_rope_b = k_rope[:, :, None, :].expand(B, S, h, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    # pad v to qk dim for the shared chunked path, then slice back
    scale = mla_scale(cfg)
    if S > CHUNK_THRESHOLD:
        vp = torch.nn.functional.pad(v, (0, q.shape[-1] - vh))
        out = chunked_sdpa(q, k, vp, positions, positions, causal=True,
                           k_valid=k_valid, scale=scale,
                           **_chunk_args(cfg, S, S))[..., :vh]
    else:
        out = sdpa(q, k, v, positions, positions, causal=True,
                   k_valid=k_valid, scale=scale)
    cache = {"ckv": ckv, "k_rope": k_rope}
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return (out if tp is None else tp.reduce_out(out)), cache


def mla_decode(cfg, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor, start: Optional[torch.Tensor] = None,
               tp=None, model=None, layout: Optional[str] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed MLA decode: attention runs in the latent space.

    score(t) = q_nope^T W_uk ckv_t + q_rope . k_rope_t
    out      = (sum_t w_t ckv_t) W_uv

    start (B,): first real cache slot per row (see gqa_decode).  The new
    latent is written into the cache's buffers in place.

    Sharded: `tp` is the heads' group (the rank's heads and latent
    columns, as in :func:`mla_forward`), `model` the model group and
    `layout` the latent cache's split over it ("seq" or None: the latent
    has no heads to split).  On a "seq" cache a rank with `tp` gathers
    every head's absorbed query over it (h x (kv_lora + rope) a row),
    attends with all heads to its slots (``parallel.split_softmax``),
    and reduce-scatters ``sum_t w_t ckv_t`` over `model` on the heads,
    so each rank receives its heads' sums;
    without `tp` the heads run whole on every rank.  On a whole cache
    the rank attends with its heads alone.  The heads' outputs are
    summed over `tp`.
    """
    seq = model if layout == "seq" else None
    Sc = cache["ckv"].shape[1]
    offset = 0 if seq is None else seq.rank * Sc
    n_slots = Sc if seq is None else Sc * seq.size
    rpos = pos if start is None else pos - start
    q_nope, q_rope = _mla_q(cfg, p, x, rpos[:, None], tp)
    ckv_new, k_rope_new = _mla_latent(cfg, p, x, rpos[:, None], tp)
    slot = (pos % n_slots).long()
    if seq is None:
        cache = {"ckv": _write_slot(cache["ckv"], ckv_new, slot),
                 "k_rope": _write_slot(cache["k_rope"], k_rope_new, slot)}
    else:
        cache = {"ckv": parallel.write_owned(cache["ckv"], ckv_new, slot,
                                             offset),
                 "k_rope": parallel.write_owned(cache["k_rope"], k_rope_new,
                                                slot, offset)}
    # absorb: q_lat (B,1,h,kvr)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    mine = None
    if tp is not None and seq is not None:
        h, kvr = q_lat.shape[2], q_lat.shape[3]
        mine = slice(tp.rank * h, (tp.rank + 1) * h)
        q = tp.all_gather(torch.cat([q_lat, q_rope], dim=-1), 2)
        q_lat, q_rope = q[..., :kvr], q[..., kvr:]
    logits = torch.einsum("bshr,btr->bhst", q_lat, cache["ckv"]).float()
    logits = logits + torch.einsum("bshk,btk->bhst", q_rope,
                                   cache["k_rope"]).float()
    logits = logits * mla_scale(cfg)
    slots = torch.arange(offset, offset + Sc, device=x.device)
    valid = slots[None, :] <= pos[:, None]
    if start is not None:
        valid &= slots[None, :] >= start[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = _softmax(logits, seq)
    o_lat = torch.einsum("bhst,btr->bshr", w.to(cache["ckv"].dtype),
                         cache["ckv"])
    o_lat = _own_heads(o_lat, seq, mine)
    out = torch.einsum("bshr,rhk->bshk", o_lat, p["w_uv"])
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return (out if tp is None else tp.reduce_out(out)), cache
