"""Unified transformer stack for the whole model zoo.

The port of ``repro.models.transformer``.  Every architecture is a
sequence of **segments**: contiguous runs of layers with identical block
structure, whose parameters are stacked on a leading layer axis (the
reference's tree, key for key).  A Python loop over the layer index
takes the place of the reference's ``lax.scan``.  Heterogeneous stacks
(Hymba's full-attention islands, DeepSeek-V2's leading dense layer)
become multiple segments.

Block anatomy (pre-norm residual):
    x += attn(ln(x))            [if seg.attn]      (GQA or MLA)
    x += ssm(ln(x))             [if seg.ssm]       (parallel to attn for Hymba)
    x += cross_attn(ln(x), enc) [if seg.cross]
    x += ffn(ln(x))             [if seg.ffn]       (SwiGLU MLP or MoE)

Every SSM layer's scan is one launch of the selective-scan kernel (K3,
see :mod:`repro_torch.models.layers.mamba`), and its gradient one launch
of K3's backward.  ``decode_step`` updates the caches in place and
returns them.

Training: ``loss_fn`` and ``forward`` take ``remat=`` (default True, as
in the reference): each layer's ``block_forward`` then runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint`` around the reference's scan body, so backward
recomputes the layer (K3 included) from its input.  The sequence-chunked
CE checkpoints each chunk, and ``chunked_sdpa`` each score block, as the
reference does.  ``_grad_dtype_guard`` needs no op here, since PyTorch
already gives a bf16 tensor a bf16 gradient, and
``optimization_barrier`` is an XLA device.

Sharded training: when the params are DTensors (placed by
``sharding.Plan``), ``loss_fn`` and ``forward`` run the sharded step of
:mod:`repro_torch.sharding.parallel`: each rank its batch shard (split
over ``act_spec``'s batch axes), each layer's params gathered over the
FSDP axis inside the layer (inside its remat), attention heads, MLP
width, SSM channels and the vocab split over "model" where they divide,
the experts too with ``moe_ep_axis``.  The vocab-sharded CE takes the
log-sum-exp over the shards with a max and a sum all-reduce; the logits
are never gathered.  With ``act_spec=Plan.act_spec(sp=True)`` the step
is sequence-parallel (Megatron-style): between sublayers each rank holds
its chunk of the sequence, and runs the norms on it; a tensor-parallel
sublayer gathers the sequence on entry and reduce-scatters its output
(``parallel.SeqGroup``), any other sublayer (the MoE router and experts
included) runs on the gathered sequence and keeps its chunk.

Remat policies (``REMAT_POLICIES``, ``loss_fn(remat_policy=...)``): the
reference's ``save_tp_out`` becomes selective activation checkpointing
(``create_selective_checkpoint_contexts``).  Its policy saves the
outputs of the TP collectives, the all-reduces (reduce-scatters under
sequence parallelism) that end each sharded sublayer
(``parallel.TP_OUT_OPS``), so the recompute in backward does
not issue them again: 4 instead of 6 residual-stream collectives a layer
(the two recomputed sums go, the two gradient sums of ``copy_in`` stay).
On one device no collective runs and the policy changes nothing.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import common, mamba as mamba_lib, moe as moe_lib
from repro_torch.sharding import parallel
from repro_torch.sharding.parallel import GATHER, SHARD, SLICE
from repro_torch.util import Device, resolve_device, tree_map

Params = Dict[str, Any]


def _save_tp_out(ctx, op, *args, **kwargs):
    """Selective remat: keep the TP collectives' outputs, recompute the
    rest."""
    return (CheckpointPolicy.MUST_SAVE if op in parallel.TP_OUT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT_POLICIES = {
    None: None,
    # save the TP-collective outputs: backward skips recomputing the
    # attention/FFN output sums (4 instead of 6 residual-stream
    # collectives per layer); costs the saved outputs per layer
    "save_tp_out": _save_tp_out,
}


class Segment(NamedTuple):
    n_layers: int
    attn: Optional[str]     # 'gqa' | 'mla' | None
    ffn: Optional[str]      # 'mlp' | 'moe' | None
    ssm: bool
    window: int             # 0 = full attention
    cross: bool             # decoder cross-attention (enc-dec archs)
    causal: bool
    d_ff: int               # MLP width when ffn == 'mlp'


def build_segments(cfg: ModelConfig, *, role: str = "decoder") -> List[Segment]:
    if role == "encoder":
        return [Segment(cfg.n_encoder_layers, "gqa", "mlp", False, 0, False, False, cfg.d_ff)]
    if cfg.family == "ssm":
        return [Segment(cfg.n_layers, None, None, True, 0, False, True, 0)]
    if cfg.family == "hybrid":
        segs: List[Segment] = []
        full = set(cfg.full_attn_layers)
        i = 0
        while i < cfg.n_layers:
            w = 0 if i in full else cfg.sliding_window
            j = i
            while j < cfg.n_layers and (0 if j in full else cfg.sliding_window) == w:
                j += 1
            segs.append(Segment(j - i, "gqa", "mlp", True, w, False, True, cfg.d_ff))
            i = j
        return segs
    attn = "mla" if cfg.use_mla else "gqa"
    if cfg.family == "moe":
        segs = []
        if cfg.moe_first_k_dense:
            segs.append(Segment(cfg.moe_first_k_dense, attn, "mlp", False, 0, False, True,
                                cfg.dense_d_ff))
        segs.append(Segment(cfg.n_layers - cfg.moe_first_k_dense, attn, "moe", False, 0,
                            False, True, 0))
        return segs
    cross = cfg.is_encoder_decoder
    return [Segment(cfg.n_layers, attn, "mlp", False, 0, cross, True, cfg.d_ff)]


# ------------------------------------------------------------------ blocks
def init_block(cfg: ModelConfig, seg: Segment, gen: torch.Generator,
               lead: Tuple = ()) -> Params:
    """One block's params, or `lead`-stacked blocks (drawn on gen's device)."""
    p: Params = {"ln1": common.init_rmsnorm(cfg.d_model, gen, lead)}
    if seg.attn == "gqa":
        p["attn"] = attn_lib.init_gqa(cfg, gen, lead)
    elif seg.attn == "mla":
        p["attn"] = attn_lib.init_mla(cfg, gen, lead)
    if seg.ssm:
        p["ssm"] = mamba_lib.init_mamba(cfg, gen, lead)
        if seg.attn:  # Hymba: parallel heads fused by normalized averaging
            p["ln_attn_out"] = common.init_rmsnorm(cfg.d_model, gen, lead)
            p["ln_ssm_out"] = common.init_rmsnorm(cfg.d_model, gen, lead)
    if seg.cross:
        p["cross"] = attn_lib.init_gqa(cfg, gen, lead)
        p["ln_cross"] = common.init_rmsnorm(cfg.d_model, gen, lead)
    if seg.ffn:
        p["ln2"] = common.init_rmsnorm(cfg.d_model, gen, lead)
        if seg.ffn == "mlp":
            p["mlp"] = common.init_mlp(cfg, gen, seg.d_ff, lead)
        else:
            p["moe"] = moe_lib.init_moe(cfg, gen, lead)
    return p


def _block_groups(cfg, seg: Segment, ctx, moe_ep_axis) -> Dict[str, Any]:
    """The group each sublayer of a sharded block splits its work over
    (the model axis, or the experts' axis), None where it gathers its
    weights and runs replicated.  The one place that decides it: the
    layers compute with these groups, and ``_block_uses`` derives the
    weights' uses from them."""
    if ctx is None:
        return {}
    groups = {"seq": ctx.seq,
              "attn": ctx.tp_for(cfg.n_heads) if seg.attn == "gqa" else None,
              "ssm": ctx.tp_for(cfg.ssm_d_inner) if seg.ssm else None,
              "mlp": ctx.tp_for(seg.d_ff) if seg.ffn == "mlp" else None}
    if seg.ffn == "moe":
        groups["moe"], groups["shared"] = moe_lib.tp_groups(cfg, ctx,
                                                            moe_ep_axis)
    return groups


def _block_uses(p: Params, groups: Dict[str, Any]) -> Any:
    """How a sharded block uses each of its weights' model-axis shards
    (see ``sharding.parallel``): a sublayer with a group computes on its
    weights' shards (Mamba on its x and z columns of ``in_proj``, a
    SLICE; the router is whole), any other gathers them.  Under sequence
    parallelism the norms run on the rank's sequence chunk: a SLICE, so
    their gradients are summed over the model axis."""
    def all_(tree, group):
        return tree_map(lambda _: GATHER if group is None else SHARD, tree)

    out = {}
    for key, sub in p.items():
        group = groups.get(key)
        if key.startswith("ln") and groups.get("seq") is not None:
            out[key] = tree_map(lambda _: SLICE, sub)
        elif key == "ssm" and group is not None:
            out[key] = {k: SLICE if k == "in_proj" else SHARD for k in sub}
        elif key == "moe":
            out[key] = {k: (all_(v, groups["shared"]) if k == "shared" else
                            all_(v, None if k == "router" else group))
                        for k, v in sub.items()}
        else:
            out[key] = all_(sub, group)
    return out


def _on_sequence(groups, key: Optional[str], fn, h):
    """``fn(h, tp) -> (out, extra)``, a sublayer on `h`.  Without
    sequence parallelism `tp` is the sublayer's group (``groups[key]``).
    With it `h` is this rank's sequence chunk: a tensor-parallel sublayer
    gets the model axis's ``SeqGroup`` (it gathers the sequence on entry
    and reduce-scatters its output), any other runs replicated on the
    gathered sequence and keeps its chunk of the output."""
    group = groups.get(key)
    seq = groups.get("seq")
    if seq is None:
        return fn(h, group)
    if group is not None:
        return fn(h, seq)
    out, extra = fn(seq.gather(h), None)
    return seq.scatter(out), extra


def _mixer_forward(cfg, seg: Segment, p: Params, x, positions, groups,
                   k_valid=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Token-mixing sublayer(s) on a full sequence; returns (dx, cache).
    `groups`: ``_block_groups``'s ({} on one device)."""
    h = common.rmsnorm(p["ln1"], x, cfg.norm_eps)
    cache: Dict[str, Any] = {}
    parts = []
    if seg.attn == "gqa":
        a, kv = _on_sequence(groups, "attn", lambda h_, tp: (
            attn_lib.gqa_forward(cfg, p["attn"], h_, positions,
                                 causal=seg.causal, window=seg.window,
                                 k_valid=k_valid, tp=tp)), h)
        cache.update(kv)
        parts.append(a)
    elif seg.attn == "mla":
        a, kv = _on_sequence(groups, None, lambda h_, _: (
            attn_lib.mla_forward(cfg, p["attn"], h_, positions,
                                 k_valid=k_valid)), h)
        cache.update(kv)
        parts.append(a)
    if seg.ssm:
        s, sc = _on_sequence(groups, "ssm", lambda h_, tp: (
            mamba_lib.mamba_forward(cfg, p["ssm"], h_, tp)), h)
        cache.update(sc)
        parts.append(s)
    if len(parts) == 2:  # Hymba fusion: mean of per-branch RMS-normed outputs
        a = common.rmsnorm(p["ln_attn_out"], parts[0], cfg.norm_eps)
        s = common.rmsnorm(p["ln_ssm_out"], parts[1], cfg.norm_eps)
        dx = 0.5 * (a + s)
    else:
        dx = parts[0]
    return dx, cache


def block_forward(cfg, seg: Segment, p: Params, x, positions, enc_out=None,
                  moe_groups: int = 1, moe_ep_axis=None, k_valid=None,
                  ctx=None,
                  ) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
    """Full-sequence block. Returns (x, cache, moe_aux).  With `ctx` (a
    sharded step) `p` is the block's local params (``_block_uses``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = _block_groups(cfg, seg, ctx, moe_ep_axis)
    dx, cache = _mixer_forward(cfg, seg, p, x, positions, groups,
                               k_valid=k_valid)
    x = x + dx
    if seg.cross:
        h = common.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        k = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc_out, p["cross"]["wv"])
        c, ckv = _on_sequence(groups, None, lambda h_, _: (
            attn_lib.gqa_forward(cfg, p["cross"], h_, positions,
                                 causal=False, kv_override=(k, v))), h)
        cache["xk"], cache["xv"] = ckv["k"], ckv["v"]
        x = x + c
    if seg.ffn:
        h = common.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if seg.ffn == "mlp":
            out, _ = _on_sequence(groups, "mlp", lambda h_, tp: (
                common.mlp(p["mlp"], h_, tp), None), h)
        else:
            # the router and the experts see the whole sequence
            out, aux = _on_sequence(groups, None, lambda h_, _: (
                moe_lib.moe_forward(cfg, p["moe"], h_, groups=moe_groups,
                                    ep_axis=moe_ep_axis, ctx=ctx)), h)
        x = x + out
    return x, cache, aux


def block_decode(cfg, seg: Segment, p: Params, x, cache: Dict[str, Any],
                 pos, moe_groups: int = 1, moe_ep_axis=None,
                 start=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Single-token block step. x: (B,1,d); pos: (B,); start: (B,) or None.
    Attention caches are written in place; the SSM state comes back new."""
    h = common.rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_cache: Dict[str, Any] = {}
    parts = []
    if seg.attn == "gqa":
        a, kv = attn_lib.gqa_decode(cfg, p["attn"], h,
                                    {"k": cache["k"], "v": cache["v"]},
                                    pos, window=seg.window, start=start)
        new_cache.update(kv)
        parts.append(a)
    elif seg.attn == "mla":
        a, kv = attn_lib.mla_decode(cfg, p["attn"], h,
                                    {"ckv": cache["ckv"], "k_rope": cache["k_rope"]},
                                    pos, start=start)
        new_cache.update(kv)
        parts.append(a)
    if seg.ssm:
        s, sc = mamba_lib.mamba_decode(cfg, p["ssm"], h,
                                       {"conv": cache["conv"], "h": cache["h"]})
        new_cache.update(sc)
        parts.append(s)
    if len(parts) == 2:
        a = common.rmsnorm(p["ln_attn_out"], parts[0], cfg.norm_eps)
        s = common.rmsnorm(p["ln_ssm_out"], parts[1], cfg.norm_eps)
        dx = 0.5 * (a + s)
    else:
        dx = parts[0]
    x = x + dx
    if seg.cross:
        h = common.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        c, _ = attn_lib.gqa_decode(cfg, p["cross"], h,
                                   {"k": cache["xk"], "v": cache["xv"]},
                                   pos, cross=True)
        new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
        x = x + c
    if seg.ffn:
        h = common.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if seg.ffn == "mlp":
            x = x + common.mlp(p["mlp"], h)
        else:
            out, _ = moe_lib.moe_forward(cfg, p["moe"], h, groups=moe_groups,
                                         ep_axis=moe_ep_axis)
            x = x + out
    return x, new_cache


# ------------------------------------------------------------------ model
def init_params(cfg: ModelConfig, gen: Optional[torch.Generator] = None, *,
                device: Device = "cuda") -> Params:
    """Random params with the reference's tree, shapes and dtypes, drawn
    from `gen` on its own device (default: a generator on `device`
    seeded 0) and placed on `device`."""
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    p: Params = common.init_embedding(cfg, gen)
    p["final_norm"] = common.init_rmsnorm(cfg.d_model, gen)

    def stack(segs):
        return [init_block(cfg, seg, gen, (seg.n_layers,)) for seg in segs]

    p["segments"] = stack(build_segments(cfg))
    if cfg.is_encoder_decoder:
        p["enc_segments"] = stack(build_segments(cfg, role="encoder"))
        p["enc_final_norm"] = common.init_rmsnorm(cfg.d_model, gen)
    return tree_map(lambda t: t.to(device), p)


def _layer(seg_params: Params, i: int) -> Params:
    """Layer i's params: views into the stacked segment."""
    return tree_map(lambda t: t[i], seg_params)


def _remat_block(cfg, seg: Segment, lp: Params, x, positions, enc_out,
                 moe_groups: int, moe_ep_axis, ctx=None, uses=None,
                 policy=None):
    """block_forward under ``torch.utils.checkpoint``: only the layer's
    input is kept (and what `policy`, a ``REMAT_POLICIES`` value, saves),
    and backward recomputes the layer.  Returns (x, aux); a training
    forward keeps no cache.  On a sharded step the layer's params are
    gathered inside, so backward gathers them again and no gathered copy
    outlives the layer."""
    def body(x, lp, enc_out):
        if ctx is not None:
            lp = ctx.localize_tree(lp, uses)
        y, _, aux = block_forward(cfg, seg, lp, x, positions, enc_out,
                                  moe_groups, moe_ep_axis, ctx=ctx)
        return y, aux
    if policy is None:
        return checkpoint(body, x, lp, enc_out, use_reentrant=False)
    return checkpoint(body, x, lp, enc_out, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, policy))


def _run_segments(cfg, segs, seg_params, x, positions, enc_out=None, *,
                  remat: bool = False, want_cache: bool = False,
                  moe_groups: int = 1, moe_ep_axis=None, k_valid=None,
                  ctx=None, remat_policy=None):
    """Run each segment layer by layer; returns (x, per-segment stacked
    caches, aux sum).  With `remat` (and autograd recording) each layer
    is rematerialized in backward (no caches, no pad mask), keeping what
    `remat_policy` names.  With `ctx` each layer's params are DTensor
    views gathered at the layer."""
    # no _grad_dtype_guard: a bf16 residual stream already gets a bf16
    # gradient in PyTorch
    remat = remat and torch.is_grad_enabled()
    if remat and (want_cache or k_valid is not None):
        raise ValueError("remat keeps no caches and takes no pad mask")
    caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg, sp in zip(segs, seg_params):
        layer_caches, auxes = [], []
        uses = (None if ctx is None else _block_uses(
            sp, _block_groups(cfg, seg, ctx, moe_ep_axis)))
        for i in range(seg.n_layers):
            if remat:
                x, aux = _remat_block(cfg, seg, _layer(sp, i), x, positions,
                                      enc_out, moe_groups, moe_ep_axis, ctx,
                                      uses, REMAT_POLICIES[remat_policy])
                auxes.append(aux)
                continue
            lp = _layer(sp, i)
            if ctx is not None:
                lp = ctx.localize_tree(lp, uses)
            x, cache, aux = block_forward(cfg, seg, lp, x,
                                          positions, enc_out, moe_groups,
                                          moe_ep_axis, k_valid, ctx=ctx)
            auxes.append(aux)
            if want_cache:
                layer_caches.append(cache)
        if want_cache:
            caches.append({k: torch.stack([c[k] for c in layer_caches])
                           for k in layer_caches[0]})
        else:
            caches.append({})
        aux_total = aux_total + torch.stack(auxes).sum()
    return x, caches, aux_total


def _top(params: Params, ctx, key: str, use: str = GATHER):
    """A top-level leaf (embedding table, final norm) as this rank uses
    it: itself on one device, localized on a sharded step."""
    return params[key] if ctx is None else ctx.localize(params[key], use)


def _vocab_tp(cfg, ctx):
    return None if ctx is None else ctx.tp_for(cfg.vocab_padded)


def _table(cfg, params: Params, ctx) -> Params:
    """The unembedding table as ``common.unembed`` reads it."""
    key = "embed" if cfg.tie_embeddings else "lm_head"
    use = SHARD if _vocab_tp(cfg, ctx) is not None else GATHER
    return {key: _top(params, ctx, key, use)}


def _encode(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = False, ctx=None):
    """The encoder stack of enc-dec archs over the stub frame embeddings."""
    enc_x = batch["frame_embeds"].to(cfg.param_dtype)
    enc_segs = build_segments(cfg, role="encoder")
    positions = torch.arange(enc_x.shape[1], device=enc_x.device)
    enc_out, _, _ = _run_segments(
        cfg, enc_segs, params["enc_segments"], _seq_chunk(ctx, enc_x),
        positions, remat=remat, ctx=ctx)
    return _seq_whole(ctx, common.rmsnorm(
        _norm_on_chunk(ctx, params["enc_final_norm"]), enc_out,
        cfg.norm_eps))


def _norm_on_chunk(ctx, leaf):
    """A final norm's scale as this rank uses it: on its sequence chunk
    under sequence parallelism (a SLICE), else whole."""
    use = SLICE if ctx is not None and ctx.seq is not None else GATHER
    return {"scale": _top(leaf, ctx, "scale", use)}


def _seq_chunk(ctx, x: torch.Tensor) -> torch.Tensor:
    """This rank's sequence chunk under sequence parallelism, else x."""
    return x if ctx is None or ctx.seq is None else ctx.seq.scatter(x)


def _seq_whole(ctx, x: torch.Tensor) -> torch.Tensor:
    """The whole sequence from the ranks' chunks (sequence parallelism),
    else x."""
    return x if ctx is None or ctx.seq is None else ctx.seq.gather(x)


def embed_inputs(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor], ctx=None) -> torch.Tensor:
    """Token + stub-frontend embedding -> (B, S, d)."""
    tp = _vocab_tp(cfg, ctx)
    table = _top(params, ctx, "embed", GATHER if tp is None else SHARD)
    x = common.embed({"embed": table}, batch["tokens"], tp)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def _hidden_states(cfg, params, batch, *, remat: bool = False,
                   moe_groups=1, moe_ep_axis=None, ctx=None,
                   remat_policy=None):
    """Forward to final hidden states (pre-unembed)."""
    enc_out = (_encode(cfg, params, batch, remat=remat, ctx=ctx)
               if cfg.is_encoder_decoder else None)
    x = embed_inputs(cfg, params, batch, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_segments(cfg, build_segments(cfg), params["segments"],
                              _seq_chunk(ctx, x), positions, enc_out,
                              remat=remat, moe_groups=moe_groups,
                              moe_ep_axis=moe_ep_axis, ctx=ctx,
                              remat_policy=remat_policy)
    norm = _norm_on_chunk(ctx, params["final_norm"])
    return _seq_whole(ctx, common.rmsnorm(norm, x, cfg.norm_eps)), aux


def _sharded_step(params: Params, batch: Dict[str, Any], act_spec):
    """(ctx, this rank's batch) of a sharded step, (None, batch) on one
    device (params that are not DTensors)."""
    ctx = parallel.context(params, batch, act_spec=act_spec)
    if ctx is None:
        return None, batch
    return ctx, {k: ctx.local_batch(v) for k, v in batch.items()}


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, remat: bool = True, act_spec=None, moe_groups: int = 1,
            moe_ep_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward to logits. Returns (logits, moe_aux).  On a sharded
    step (DTensor params) every rank passes the same global batch and
    gets the full logits, gathered from the ranks' rows and vocab shards
    (``Plan.logits_spec``'s layout)."""
    ctx, local = _sharded_step(params, batch, act_spec)
    x, aux = _hidden_states(cfg, params, local, remat=remat,
                            moe_groups=moe_groups, moe_ep_axis=moe_ep_axis,
                            ctx=ctx)
    tp = _vocab_tp(cfg, ctx)
    logits = common.unembed(cfg, _table(cfg, params, ctx), x, tp)
    if ctx is None:
        return logits, aux
    return ctx.gather_out(logits, shard_last=tp is not None), aux


LOSS_CHUNK = 512  # sequence-chunked CE above this length (memory-linear)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, tp
               ) -> torch.Tensor:
    """Per-token NLL of f32 logits (this rank's vocab shard with `tp`)."""
    if tp is not None:
        return common.sharded_nll(logits, labels, tp)
    return common.token_nll(logits, labels)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, aux_coef: float = 0.01, remat: bool = True, act_spec=None,
            moe_groups: int = 1, moe_ep_axis=None,
            remat_policy=None) -> torch.Tensor:
    """Mean next-token NLL plus `aux_coef` times the MoE aux loss;
    differentiable (``loss.backward()`` or ``torch.autograd.grad``).
    On a sharded step (DTensor params) it is the global batch's loss on
    every rank, and the gradients reach the DTensor params in their own
    placements.  ``remat_policy`` names a ``REMAT_POLICIES`` entry (an
    unknown name raises).  ``act_spec=Plan.act_spec(sp=True)`` runs the
    step sequence-parallel; the outputs ``save_tp_out`` saves are then
    kept as the TP collectives leave them, split on the sequence."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"loss_fn: unknown remat_policy {remat_policy!r}; "
                         f"known: {sorted(k for k in REMAT_POLICIES if k)}")
    ctx, batch = _sharded_step(params, batch, act_spec)
    x, aux = _hidden_states(cfg, params, batch, remat=remat,
                            moe_groups=moe_groups, moe_ep_axis=moe_ep_axis,
                            ctx=ctx, remat_policy=remat_policy)
    tp = _vocab_tp(cfg, ctx)
    table = _table(cfg, params, ctx)
    labels, mask = batch["labels"], batch["mask"].float()
    if cfg.frontend == "vision":  # frontend tokens carry no LM loss
        pad = x.shape[1] - labels.shape[1]
        x = x[:, pad:]
    S = labels.shape[1]
    if S > LOSS_CHUNK and S % LOSS_CHUNK == 0:
        # chunk the unembed+CE over the sequence: the (B, S, V) f32
        # logits never materialize, and backward recomputes them chunk
        # by chunk (the reference's @jax.checkpoint chunk_nll)
        def chunk_nll(xc, lc, mc):
            logits = common.unembed(cfg, table, xc, tp)
            return torch.sum(_token_nll(logits, lc, tp) * mc)

        tot = torch.zeros((), device=x.device)
        cnt = torch.zeros((), device=x.device)
        for c in range(S // LOSS_CHUNK):
            sl = slice(c * LOSS_CHUNK, (c + 1) * LOSS_CHUNK)
            args = (x[:, sl], labels[:, sl], mask[:, sl])
            tot = tot + (checkpoint(chunk_nll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else chunk_nll(*args))
            cnt = cnt + torch.sum(mask[:, sl])
    else:
        logits = common.unembed(cfg, table, x, tp)
        tot = torch.sum(_token_nll(logits, labels, tp) * mask)
        cnt = torch.sum(mask)
    if ctx is None:
        return tot / cnt.clamp_min(1.0) + aux_coef * aux
    # every rank adds its share (the global count's, and 1 / n_batch of
    # the aux loss, which every rank holds whole): the batch axes' sum
    # is the global loss
    nll = tot / ctx.batch_sum(cnt).clamp_min(1.0)
    return ctx.batch_sum(nll + (aux_coef / ctx.n_batch) * aux)


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, seg: Segment, n_layers: int, batch: int,
               max_seq: int, enc_len: int = 0, *,
               device: Device = "cuda") -> Dict[str, Any]:
    """Zeroed stacked decode cache for one segment."""
    dt = cfg.param_dtype
    S = min(max_seq, seg.window) if seg.window else max_seq

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    c: Dict[str, Any] = {}
    if seg.attn == "gqa":
        c["k"] = zeros(n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim_)
        c["v"] = zeros(n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim_)
    elif seg.attn == "mla":
        c["ckv"] = zeros(n_layers, batch, S, cfg.kv_lora_rank)
        c["k_rope"] = zeros(n_layers, batch, S, cfg.qk_rope_dim)
    if seg.ssm:
        c["conv"] = zeros(n_layers, batch, cfg.ssm_d_conv - 1, cfg.ssm_d_inner)
        c["h"] = zeros(n_layers, batch, cfg.ssm_d_inner, cfg.ssm_d_state,
                       dtype=torch.float32)
    if seg.cross:
        c["xk"] = zeros(n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
        c["xv"] = zeros(n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
    return c


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                enc_len: int = 0, *, device: Device = "cuda"
                ) -> List[Dict[str, Any]]:
    """Zeroed decode caches, one dict per segment (``device="meta"`` gives
    shapes and dtypes only)."""
    device = resolve_device(device)
    return [init_cache(cfg, seg, seg.n_layers, batch, max_seq, enc_len,
                       device=device)
            for seg in build_segments(cfg)]


def grow_caches(caches: List[Dict[str, Any]], into: List[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """Copy prefill caches (sized to the prompt) into the front of decode
    buffers such as :func:`init_caches` gives; returns `into`."""
    for cache, buf in zip(caches, into):
        for k, v in cache.items():
            buf[k][tuple(slice(0, n) for n in v.shape)].copy_(v)
    return into


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, moe_groups: int = 1, moe_ep_axis=None,
            positions: Optional[torch.Tensor] = None,
            pad_mask: Optional[torch.Tensor] = None,
            ) -> Tuple[List[Dict[str, Any]], torch.Tensor]:
    """Run the full prompt; returns (caches, last-position logits).

    For left-padded (bucketed) prompts pass ``pad_mask`` — an (S,) bool
    that is False on pad slots, so they are never attended — and
    ``positions = arange(S) - n_pad`` so real tokens keep the RoPE
    positions they would have in the unpadded prompt. Together the two
    make a padded prefill bit-identical (masked keys contribute exactly
    zero softmax weight) to the unpadded one.
    """
    segs = build_segments(cfg)
    enc_out = _encode(cfg, params, batch) if cfg.is_encoder_decoder else None
    x = embed_inputs(cfg, params, batch)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, caches, _ = _run_segments(cfg, segs, params["segments"], x, positions,
                                 enc_out, want_cache=True,
                                 moe_groups=moe_groups,
                                 moe_ep_axis=moe_ep_axis, k_valid=pad_mask)
    x = common.rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = common.unembed(cfg, params, x)
    # prefill caches for windowed segments keep only the trailing window
    out_caches = []
    for seg, cache in zip(segs, caches):
        if seg.window and cache.get("k") is not None:
            W = seg.window
            S = cache["k"].shape[2]
            if S > W:
                # slot of absolute position p is (p % W): index i in the
                # trailing-window slice holds p = S - W + i  ->  roll by S % W
                cache = {k: (torch.roll(v[:, :, S - W:], S % W, dims=2)
                             if k in ("k", "v") else v)
                         for k, v in cache.items()}
        out_caches.append(cache)
    return out_caches, logits


def decode_step(cfg: ModelConfig, params: Params, caches: List[Dict[str, Any]],
                tokens: torch.Tensor, pos: torch.Tensor, *, moe_groups: int = 1,
                moe_ep_axis=None, start: Optional[torch.Tensor] = None,
                ) -> Tuple[List[Dict[str, Any]], torch.Tensor]:
    """One decode step. tokens: (B,1) int; pos: (B,) absolute positions.

    start (B,) marks the first real (non-pad) cache slot per row; pad
    slots below it are masked out and RoPE runs pad-relative.  The caches
    are updated in place and returned.
    """
    segs = build_segments(cfg)
    x = common.embed(params, tokens)
    for seg, sp, cache in zip(segs, params["segments"], caches):
        for i in range(seg.n_layers):
            lc = {k: v[i] for k, v in cache.items()}
            x, nc = block_decode(cfg, seg, _layer(sp, i), x, lc, pos,
                                 moe_groups=moe_groups,
                                 moe_ep_axis=moe_ep_axis, start=start)
            for k, v in nc.items():
                if v is not lc[k]:     # attention buffers were written in place
                    cache[k][i].copy_(v)
    x = common.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return caches, common.unembed(cfg, params, x)
