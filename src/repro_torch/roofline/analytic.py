"""Loop-aware analytic FLOP and HBM-traffic model.

The port of ``repro.roofline.analytic``, over the port's ``ModelConfig``
and ``transformer.build_segments``.  The arithmetic is the reference's,
unchanged, and gives the reference's numbers exactly: that is what lets
a dry-run record, a Session's stage estimate and the roofline table
compare across the two packages.  So it counts what the reference's
compiled program executes, even where the port's own kernels do less:

  * every (q, kv) block pair of attention (the chunked implementation
    computes them all and masks afterwards), window or not;
  * ~3x the sequential work for the selective scan, the cost of the
    reference's ``lax.associative_scan`` (K3 here walks S once);
  * remat's recompute (a train step is 4 forwards, 3 without remat).

All numbers are GLOBAL (whole step, all devices); divide by the device
count for per-device terms.  Model FLOP utilisation on the card is
``model_flops / (wall_s * HW.peak_flops)``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.roofline.terms import ssm_scan_terms


def _attn_flops_gqa(cfg: ModelConfig, B: int, S: int, S_kv: int,
                    window: int) -> float:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    proj = 2 * B * S * d * (h + 2 * kv) * hd + 2 * B * S * h * hd * d
    # the chunked/full impl computes every (q, kv) block pair (mask applied
    # afterwards) -> score FLOPs scale with full S * S_kv, window or not.
    score = 2 * 2 * B * h * S * S_kv * hd
    return proj + score


def _attn_flops_mla(cfg: ModelConfig, B: int, S: int, S_kv: int,
                    decode_absorbed: bool) -> float:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    f = 2 * B * S * d * qr + 2 * B * S * qr * h * (nope + rope)      # q path
    f += 2 * B * S * d * (kvr + rope)                                # latent
    if decode_absorbed:
        f += 2 * B * S * h * nope * kvr                              # q absorb
        f += 2 * B * h * S * S_kv * (kvr + rope)                     # scores
        f += 2 * B * h * S * S_kv * kvr                              # o latent
        f += 2 * B * S * h * kvr * vh                                # v expand
    else:
        f += 2 * B * S_kv * kvr * h * (nope + vh)                    # k/v expand
        f += 2 * 2 * B * h * S * S_kv * (nope + rope)                # scores+out
    f += 2 * B * S * h * vh * d                                      # wo
    return f


def _mlp_flops(cfg: ModelConfig, B: int, S: int, d_ff: int) -> float:
    return 3 * 2 * B * S * cfg.d_model * d_ff


def _moe_flops(cfg: ModelConfig, B: int, S: int) -> float:
    d = cfg.d_model
    T = B * S
    e = cfg.moe_n_routed_padded
    cap = max(8, ((int(-(-cfg.moe_capacity_factor * T * cfg.moe_top_k // e)) + 7)
                  // 8) * 8)
    router = 2 * T * d * e
    experts = 3 * 2 * e * cap * d * cfg.moe_d_ff
    shared = _mlp_flops(cfg, B, S, cfg.moe_n_shared * cfg.moe_d_ff)
    return router + experts + shared


def _ssm_flops(cfg: ModelConfig, B: int, S: int) -> float:
    d, di, st = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
    dr, dc = cfg.ssm_dt_rank_, cfg.ssm_d_conv
    f = 2 * B * S * d * 2 * di                    # in_proj
    f += 2 * B * S * dc * di                      # conv
    f += 2 * B * S * di * (dr + 2 * st)           # x_proj
    f += 2 * B * S * dr * di                      # dt_proj
    scan, readout = ssm_scan_terms(B, S, di, st)
    f += scan                                     # assoc scan (~3x sequential)
    f += readout                                  # C readout
    f += 2 * B * S * di * d                       # out_proj
    return f


def forward_flops(cfg: ModelConfig, B: int, S: int, *, S_kv: int = 0,
                  decode: bool = False) -> float:
    """One forward pass, global FLOPs. S_kv = attention context length."""
    S_kv = S_kv or S
    total = 0.0
    for seg in transformer.build_segments(cfg):
        per = 0.0
        if seg.attn == "gqa":
            per += _attn_flops_gqa(cfg, B, S, S_kv, seg.window)
        elif seg.attn == "mla":
            per += _attn_flops_mla(cfg, B, S, S_kv, decode_absorbed=decode)
        if seg.ssm:
            per += _ssm_flops(cfg, B, S)
        if seg.cross:
            enc_len = 4096 if decode else S_kv
            per += _attn_flops_gqa(cfg, B, S, enc_len, 0)
        if seg.ffn == "mlp":
            per += _mlp_flops(cfg, B, S, seg.d_ff)
        elif seg.ffn == "moe":
            per += _moe_flops(cfg, B, S)
        total += seg.n_layers * per
    if cfg.is_encoder_decoder and not decode:
        enc = 0.0
        for seg in transformer.build_segments(cfg, role="encoder"):
            enc += seg.n_layers * (_attn_flops_gqa(cfg, B, S_kv, S_kv, 0)
                                   + _mlp_flops(cfg, B, S_kv, seg.d_ff))
        total += enc
    total += 2 * B * S * cfg.d_model * cfg.vocab_padded   # unembed
    return total


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops: float            # global FLOPs for one step
    hbm_bytes: float        # global HBM traffic for one step
    model_flops: float      # 6*N*D (dense) / 6*N_active*D useful-FLOP floor


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.n_params() * 2.0  # bf16 weights


def step_cost(cfg: ModelConfig, shape: ShapeConfig, *, n_devices: int,
              tp: int = 16, n_microbatches: int = 1,
              remat: bool = True) -> StepCost:
    """Analytic cost of the lowered step for one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    P = _param_bytes(cfg)
    layers = cfg.n_layers + cfg.n_encoder_layers
    act_unit = cfg.d_model * 2  # bf16

    if shape.kind == "train":
        mb = B // n_microbatches
        fwd = forward_flops(cfg, mb, S) * n_microbatches
        mult = 4.0 if remat else 3.0   # fwd + (remat fwd) + bwd(2x)
        flops = fwd * mult
        tokens = B * S
        model_flops = 6.0 * cfg.n_active_params() * tokens
        # HBM traffic (per step, global):
        #   weights: FSDP gather means every device streams the full
        #   TP-shard of the model per microbatch, fwd + bwd + remat
        weight_traffic = 3.0 * (P / tp) * n_devices * n_microbatches
        opt_traffic = P / 2 * (4 + 8 + 8 + 8)   # p rw + m rw + v rw (f32)
        act_traffic = 8.0 * layers * tokens * act_unit  # residual-level rw
        return StepCost(flops, weight_traffic + opt_traffic + act_traffic,
                        model_flops)

    if shape.kind == "prefill":
        flops = forward_flops(cfg, B, S)
        model_flops = 2.0 * cfg.n_active_params() * B * S
        weight_traffic = (P / tp) * n_devices
        act_traffic = 6.0 * layers * B * S * act_unit
        cache_write = _cache_bytes(cfg, B, S)
        return StepCost(flops, weight_traffic + act_traffic + cache_write,
                        model_flops)

    # decode: one token against an S-deep cache
    flops = forward_flops(cfg, B, 1, S_kv=S, decode=True)
    model_flops = 2.0 * cfg.n_active_params() * B
    weight_traffic = (P / tp) * n_devices
    cache_traffic = _cache_bytes(cfg, B, S)   # read whole cache
    return StepCost(flops, weight_traffic + cache_traffic, model_flops)


def _cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    total = 0.0
    for seg in transformer.build_segments(cfg):
        Sc = min(S, seg.window) if seg.window else S
        per = 0.0
        if seg.attn == "gqa":
            per += 2 * B * Sc * cfg.n_kv_heads * cfg.head_dim_ * 2
        elif seg.attn == "mla":
            per += B * Sc * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        if seg.ssm:
            per += B * cfg.ssm_d_inner * (cfg.ssm_d_state * 4 + (cfg.ssm_d_conv - 1) * 2)
        if seg.cross:
            per += 2 * B * 4096 * cfg.n_kv_heads * cfg.head_dim_ * 2
        total += seg.n_layers * per
    return total
