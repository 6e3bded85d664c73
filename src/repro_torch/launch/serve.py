"""Serving launcher: batched prefill+decode of a small model on a Pilot.

The port of ``repro.launch.serve``:

``python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8 --gen 16``

runs on the card (``--device cpu`` runs the same on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import (ComputeUnitDescription, PilotDescription,
                              PilotManager, ResourceManager)
from repro_torch.data.batches import make_batch
from repro_torch.models import transformer
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.util import Device, resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, *, n_requests: int, prompt_len: int, gen: int,
                seed: int = 0, device: Device = "cuda"):
    """Prefill a request batch then decode `gen` tokens greedily."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    batch = make_batch(cfg, "prefill", n_requests, prompt_len, rng,
                       device=device)
    max_seq = prompt_len + gen
    _sync(device)
    t0 = time.monotonic()
    caches, logits = make_prefill_step(cfg)(params, batch)
    # grow caches to max_seq decode buffers
    enc_len = batch["frame_embeds"].shape[1] if cfg.is_encoder_decoder else 0
    caches = transformer.grow_caches(caches, transformer.init_caches(
        cfg, n_requests, max_seq, enc_len, device=device))
    _sync(device)
    prefill_s = time.monotonic() - t0

    step = make_decode_step(cfg, sample=True)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1).to(
        torch.int32)[:, None]
    out_tokens = [tok]
    t1 = time.monotonic()
    for t in range(gen - 1):
        pos = torch.full((n_requests,), n_front + prompt_len + t,
                         dtype=torch.int32, device=device)
        caches, _, tok = step(params, caches, tok, pos)
        out_tokens.append(tok)
    _sync(device)
    decode_s = time.monotonic() - t1
    tokens = torch.cat(out_tokens, dim=1)
    return {"tokens": tokens.cpu().numpy(), "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tok_per_s": n_requests * (gen - 1) / max(decode_s, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.port_names())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    device = resolve_device(args.device)
    pm = PilotManager(ResourceManager(
        devices=[device] if device.type == "cpu" else None))
    try:
        pilot = pm.submit(PilotDescription(n_chips=1, name="serve"))
        cu = pilot.submit(ComputeUnitDescription(
            fn=lambda mesh=None: serve_batch(
                cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                gen=args.gen, device=mesh.devices.flat[0]),
            n_chips=1, gang=True, tag="serve"))
        res = cu.wait(600)
    finally:
        pm.shutdown()
    print(f"prefill {res['prefill_s']*1e3:.0f} ms, "
          f"decode {res['decode_s']*1e3:.0f} ms, "
          f"{res['tok_per_s']:.1f} tok/s, tokens shape {res['tokens'].shape}")
    return res


if __name__ == "__main__":
    main()
