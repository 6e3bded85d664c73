#!/usr/bin/env python3
"""Does a request's decode depend on how many rows the decode batch has?

Run from the repository root on a machine with one CUDA card:

    python3 tools/decode_rows.py [--out FILE.json]

Hymba-1.5B at full width and depth in bf16, with the weights and the
prompts of ``chip_smoke.py`` phase 12 (its seed).

1. Tokens: each prompt served alone through an engine of 1 slot and one
   of 4 slots (the two decode widths of phase 12b).  For a request whose
   tokens differ, the first step that differs and, at that step, the
   logits of both tokens in both engines (the gap that decided it).
2. Ops: one decode step of a request in row 0 of batches of ``ROWS``
   rows (the same request also in the last row), every aten op's output
   recorded (``TorchDispatchMode``; views left out): the ops whose row 0
   differs from the 4-row batch's, first one first, and whether the
   first and last rows agree.  Repeated with
   ``allow_bf16_reduced_precision_reduction`` off.

Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ROWS = (1, 2, 4, 8, 16)     # decode batch widths compared, op by op,
BASE_ROWS = 4               # with this one (phase 12a's)
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def serve_alone(torch, dev, cfg, params, prompt, slots: int, cs):
    """(tokens, per-step last-position logits of the request's row)."""
    from repro_torch.serve import ModelBackend, Request, ServeEngine
    backend = ModelBackend(cfg, params, device=dev)
    logits = []
    decode = backend._decode

    def recording(params_, caches, tok, pos, start):
        out = decode(params_, caches, tok, pos, start)
        logits.append(out[1][:, -1].float().cpu())
        return out

    backend._decode = recording
    engine = ServeEngine(cfg, backend=backend, slots=slots,
                         max_seq=cs.ENGINE_MAX_SEQ,
                         prompt_bucket=cs.ENGINE_BUCKET)
    req = Request(uid=0, tokens=prompt, max_new=cs.ENGINE_MAX_NEW)
    engine.submit(req)
    engine.run_until_drained()
    row = engine.slots - 1          # the slot a lone request takes
    return req.output, [lg[row] for lg in logits]


def token_report(torch, dev, cfg, params, prompts, cs) -> list:
    rows = []
    for i, p in enumerate(prompts):
        t1, l1 = serve_alone(torch, dev, cfg, params, p, 1, cs)
        t4, l4 = serve_alone(torch, dev, cfg, params, p, 4, cs)
        diff = [s for s, (a, b) in enumerate(zip(t1, t4)) if a != b]
        rec = {"request": i, "prompt": len(p), "equal": not diff,
               "max_abs_logit_diff": [float((a - b).abs().max())
                                      for a, b in zip(l1, l4)]}
        if diff:
            s = diff[0]
            # tokens[s] is sampled from the logits of decode step s - 1
            a, b = int(t1[s]), int(t4[s])
            lg1, lg4 = l1[s - 1], l4[s - 1]
            rec |= {"first_step": s, "token_1_slot": a, "token_4_slots": b,
                    "logits_1_slot": [float(lg1[a]), float(lg1[b])],
                    "logits_4_slots": [float(lg4[a]), float(lg4[b])]}
        rows.append(rec)
        print(f"  request {i} (prompt {len(p)}): "
              + ("equal" if not diff else
                 f"differs from step {rec['first_step']}: 1 slot token "
                 f"{rec['token_1_slot']} (logits {rec['logits_1_slot']}), "
                 f"4 slots token {rec['token_4_slots']} (logits "
                 f"{rec['logits_4_slots']})")
              + f"; max |logit diff| a step "
              f"{max(rec['max_abs_logit_diff']):.4e}")
    return rows


def op_report(torch, dev, cfg, params, prompts, cs) -> dict:
    """One decode step at 1 and 4 rows, op by op."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.serve import ModelBackend
    backend = ModelBackend(cfg, params, device=dev)
    pres = [backend.prefill(p, -(-len(p) // cs.ENGINE_BUCKET)
                            * cs.ENGINE_BUCKET) for p in prompts[:3]]

    class Recorder(TorchDispatchMode):
        def __init__(self, rows: int):
            super().__init__()
            self.rows, self.log = rows, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:      # views compute nothing, and a 1-row
                return out        # batch takes a few more of them
            t = out[0] if isinstance(out, (tuple, list)) else out
            keep = None
            if (isinstance(t, torch.Tensor) and t.dim() >= 1
                    and t.shape[0] == self.rows and t.is_floating_point()
                    and t[0].numel() <= 1 << 22):
                keep = (t[0].float().cpu(),
                        t[-1].float().cpu() if self.rows > 1 else None)
            self.log.append((str(func), tuple(t.shape)
                             if isinstance(t, torch.Tensor) else None, keep))
            return out

    def step(rows: int):
        """Request 0 in the first and the last row, others between."""
        state = backend.make_state(rows, cs.ENGINE_MAX_SEQ)
        order = [0] if rows == 1 else \
            [0] + [1 + i % 2 for i in range(rows - 2)] + [0]
        for slot, k in enumerate(order):
            backend.splice(state, slot, pres[k])
        pos = [pres[k].bucket for k in order]
        start = [pres[k].pad for k in order]
        with Recorder(rows) as rec:
            backend.step(state, np.array(pos, np.int32),
                         np.array(start, np.int32))
        return rec.log

    out = {}
    for label, reduced in (("default", True), ("no bf16 reduced-precision "
                                               "reduction", False)):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        logs = {rows: step(rows) for rows in ROWS}
        out[label] = {}
        for rows in ROWS:
            if rows == BASE_ROWS:
                continue
            one, four = logs[rows], logs[BASE_ROWS]
            same_path = [a[0] for a in one] == [b[0] for b in four]
            diffs, first_last = [], 0
            for i, (a, b) in enumerate(zip(one, four)):
                if a[2] is not None and a[2][1] is not None \
                        and not torch.equal(a[2][0], a[2][1]):
                    first_last += 1
                if a[2] is None or b[2] is None \
                        or a[2][0].shape != b[2][0].shape:
                    continue
                if not torch.equal(a[2][0], b[2][0]):
                    diffs.append({"op": i, "name": a[0], "shape": a[1],
                                  "shape_base": b[1], "max_abs_diff": float(
                                      (a[2][0] - b[2][0]).abs().max())})
            names = sorted({d["name"] for d in diffs})
            out[label][rows] = {
                "ops": len(one), "same_op_sequence": same_path,
                "ops_differing": len(diffs), "first": diffs[:12],
                "differing_op_names": names,
                "ops_with_first_and_last_row_apart": first_last}
            print(f"  {label}, {rows} rows vs {BASE_ROWS}: {len(one)} ops, "
                  f"same op sequence {same_path}, {len(diffs)} ops with row 0"
                  f" apart ({names}); its first and last row (the same "
                  f"request) apart in {first_last} ops")
            for d in diffs[:4]:
                print(f"    op {d['op']} {d['name']} {d['shape']} vs "
                      f"{d['shape_base']}: max |diff| {d['max_abs_diff']:.4e}")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_rows: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import mamba_scan as ms_k
    from repro_torch.launch import platform
    from repro_torch.models import transformer as tf
    platform.configure("cuda")
    build.build_all([ms_k.SOURCE])
    cfg = configs.get(cs.ENGINE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(cs.ENGINE_SEED)
    params = tf.init_params(cfg, gen, device="cuda")
    prompts = cs.engine_prompts(cfg.vocab_size)
    print(f"tokens: each of {len(prompts)} prompts alone, 1 slot vs 4 slots")
    dev = torch.device("cuda")
    res = {"tokens": token_report(torch, dev, cfg, params, prompts, cs)}
    print(f"ops: one decode step, row 0 at {ROWS} rows")
    res["ops"] = op_report(torch, dev, cfg, params, prompts, cs)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
