"""A witness for the serving check: does the program's decode step give
the logits its own full-sequence forward gives, at the cell's widths?

For a prompt of one bucket (1024 tokens: decode positions under the
2048-token window) and one of two (2048: at the window and past it),
each followed by some tokens (``--cases prompt:tokens``; the forward
takes whole chunks, so their sum is a multiple of 256, and of 1024 past
2048), the program's prefill plus teacher-forced decode steps against the
program's ``transformer.forward`` over the whole sequence, and that
forward against the plain reference, in float32 (so that rounding reads
~1e-5) and in the configuration's bf16.

    python3 bench/tools/decode_witness.py --seed 3

One JSON line a case: the largest |logit| difference over the decoded
positions, decode against forward and forward against the reference.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import run as entry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cases", default="1024:256,2048:1024")
    ap.add_argument("--config", default="hymba-1.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    args = ap.parse_args(argv)
    entry.environment()
    import torch
    from lib import seeds
    from lib.model import model_config
    from reference import hymba
    from repro_torch.models import transformer
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    with open(BENCH / "configs" / f"{args.config}.json") as f:
        base = json.load(f)
    for dtype in args.dtypes.split(","):
        cfg = dict(base, dtype=dtype)
        c = model_config(cfg)
        params = hymba.init_params(cfg, seeds.derive(args.seed, "weights"),
                                   dev)
        prefill, decode = make_prefill_step(c), make_decode_step(c)
        for case in args.cases.split(","):
            plen, steps = (int(x) for x in case.split(":"))
            gen = torch.Generator(device=dev).manual_seed(
                seeds.derive(args.seed, "tokens", plen))
            seq = torch.randint(0, cfg["vocab_size"], (1, plen + steps),
                                generator=gen, device=dev)
            caches, _ = prefill(params, {"tokens": seq[:, :plen].int()})
            buf = transformer.init_caches(c, 1, plen + steps + 1,
                                          device=dev)
            transformer.grow_caches(caches, buf)
            dec = []
            for i in range(steps - 1):
                pos = torch.tensor([plen + i], dtype=torch.int32, device=dev)
                buf, lg = decode(params, buf,
                                 seq[:, plen + i:plen + i + 1].int(), pos)
                dec.append(lg[0, -1, :cfg["vocab_size"]].float())
            with torch.no_grad():
                full, _ = transformer.forward(c, params, {"tokens": seq},
                                              remat=False)
                ref = hymba.logits(cfg, params, hymba.hidden(cfg, params,
                                                             seq))
            at = slice(plen, plen + steps - 1)
            full = full[0, at, :cfg["vocab_size"]].float()
            ref = ref[0, at]
            dec = torch.stack(dec)
            line = {"dtype": dtype, "prompt": plen, "tokens": steps,
                    "window": cfg["sliding_window"],
                    "decode_vs_forward": float((dec - full).abs().max()),
                    "forward_vs_reference": float((full - ref).abs().max()),
                    "decode_vs_reference": float((dec - ref).abs().max()),
                    "logit_scale": float(ref.abs().max()),
                    "device": str(dev)}
            print(json.dumps(line), flush=True)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
