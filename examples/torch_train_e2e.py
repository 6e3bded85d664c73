"""End-to-end run on the port: train a ~100M-param llama on synthetic
data through the full stack (Pilot -> gang CU -> Trainer with prefetching
pipeline + async checkpointing).  The PyTorch counterpart of
``examples/train_e2e.py``; on the card by default:

    PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300] [--small]

``--small`` shrinks to the smoke config; ``--device cpu`` runs on the CPU.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.small:
        cfg = configs.get_smoke("llama3.2-1b")
        batch, seq = 8, 64
    else:
        # ~100M params: 12L x d768 llama-style
        cfg = dataclasses.replace(
            configs.get("llama3.2-1b"), n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
            dtype="float32")
        batch, seq = 8, 256

    n_params = cfg.n_params()
    print(f"arch {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {batch} x seq {seq}")
    out = train(cfg, steps=args.steps, batch=batch, seq=seq, lr=3e-3,
                ckpt_dir=args.ckpt_dir, ckpt_every=100, warmup_steps=20,
                total_steps=args.steps, log_every=25, device=args.device)
    hist = out["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {len(hist)} steps "
          f"({1e3*sum(h['step_s'] for h in hist)/len(hist):.0f} ms/step); "
          f"checkpoints in {args.ckpt_dir}")
    return hist


if __name__ == "__main__":
    main()
