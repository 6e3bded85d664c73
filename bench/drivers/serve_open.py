"""A model served under an open loop: the program's ``ServeEngine`` with a
``ModelBackend``, its ``run_forever`` loop on a thread of its own, fed
requests at the times a fixed schedule makes them due.

Configuration: the model's sizes (the program's ``ModelConfig`` fields).
Traffic (``workloads/<cell>.json``): ``slots``, ``prompt_bucket`` and
``max_seq`` of the engine; ``rate_per_s``, the mean arrival rate;
``prompt_tokens`` and ``output_tokens``, [low, high] of log-uniform
lengths; ``grace_s``, how long past the window the requests due in it
may take to finish; ``check_tokens``, how many served tokens the
reference reads at least; ``warmup_new``, the tokens each warm-up
request decodes.

Every seed gets the same multiset of prompt lengths, output lengths and
arrival gaps (stratified quantiles of the log-uniform and exponential
distributions), in an order of its own, and token ids uniform over the
vocabulary: the seed changes the order, not the amount of work.  Each
request is timed from when it was due.  Decoding is greedy.
"""
from __future__ import annotations

import math
import random
import sys
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from lib import seeds
from lib.model import model_config
from reference import hymba

TIMEOUT_S = 600.0


def schedule(run) -> List[Dict[str, Any]]:
    """The window's requests: due time (seconds after the window opens),
    prompt length and output length, in due order."""
    tr = run.traffic
    n = max(1, round(tr["rate_per_s"] * run.seconds))
    u = [(i + 0.5) / n for i in range(n)]

    def loguniform(lo, hi):
        return [int(round(math.exp(math.log(lo) + x * (math.log(hi)
                                                       - math.log(lo)))))
                for x in u]
    plens = loguniform(*tr["prompt_tokens"])
    outs = loguniform(*tr["output_tokens"])
    gaps = [-math.log(1.0 - x) for x in u]
    scale = run.seconds / sum(gaps)
    rng = random.Random(seeds.derive(run.seed, "schedule"))
    for xs in (plens, outs, gaps):
        rng.shuffle(xs)
    due, t = [], 0.0
    for g in gaps:
        due.append(t)
        t += g * scale
    return [{"uid": i, "due_in": due[i], "plen": plens[i], "n_out": outs[i]}
            for i in range(n)]


def prompt(run, uid: int, plen: int) -> np.ndarray:
    rng = np.random.default_rng(seeds.derive(run.seed, "prompt", uid))
    return rng.integers(0, run.config["vocab_size"], plen, dtype=np.int32)


def bucket_of(tr, plen: int) -> int:
    """The bucket the engine pads a prompt to (its rule, worked out
    again): the next multiple of ``prompt_bucket``, at most max_seq."""
    b = tr["prompt_bucket"]
    return min(tr["max_seq"], -(-plen // b) * b)


class Timed:
    """The backend, with a benchmark span around each call."""

    def __init__(self, inner, run):
        self.inner = inner
        self.run = run
        self.prefill_start: Dict[int, float] = {}

    def make_state(self, slots, max_seq):
        return self.inner.make_state(slots, max_seq)

    def prefill(self, tokens, bucket):
        self.prefill_start[id(tokens)] = time.monotonic()
        with self.run.spans.span("bench.prefill", bucket=bucket,
                                 tokens=len(tokens)):
            return self.inner.prefill(tokens, bucket)

    def splice(self, state, slot, pre):
        self.inner.splice(state, slot, pre)

    def step(self, state, pos, start):
        with self.run.spans.span("bench.step"):
            return self.inner.step(state, pos, start)


def setup(run) -> None:
    t0 = time.monotonic()
    from repro_torch.serve.engine import ModelBackend, Request, ServeEngine
    run.part("imports", t0)
    cfg, tr, dev = model_config(run.config), run.traffic, run.device
    t0 = time.monotonic()
    params = hymba.init_params(run.config, seeds.derive(run.seed, "weights"),
                               dev)
    run.sync()
    run.part("weights", t0)
    t0 = time.monotonic()
    backend = Timed(ModelBackend(cfg, params, device=dev), run)
    engine = ServeEngine(cfg, backend=backend, slots=tr["slots"],
                         max_seq=tr["max_seq"],
                         prompt_bucket=tr["prompt_bucket"],
                         name=run.cell.name)
    run.sync()
    run.part("engine", t0)
    # warm-up: one prompt of every bucket the traffic reaches, decoded
    # together at the full slot width
    t0 = time.monotonic()
    lo, hi = tr["prompt_tokens"]
    buckets = sorted({bucket_of(tr, p) for p in range(lo, hi + 1)})
    for i, b in enumerate(buckets):
        engine.submit(Request(uid=-1 - i, tokens=prompt(run, -1 - i, b),
                              max_new=int(tr["warmup_new"])))
    engine.run_until_drained(timeout_s=TIMEOUT_S)
    run.sync()
    run.part("warmup", t0)
    run.records.update(engine=engine, backend=backend, Request=Request,
                       requests=[], schedule=schedule(run))


def window(run, deadline: float) -> None:
    tr = run.traffic
    engine, backend = run.records["engine"], run.records["backend"]
    Request = run.records["Request"]
    stop = threading.Event()
    loop = threading.Thread(target=engine.run_forever, args=(stop,),
                            name="engine")
    loop.start()
    t_open = run.window_start
    live, late = [], []
    try:
        for item in run.records["schedule"]:
            due = t_open + item["due_in"]
            while (left := due - time.monotonic()) > 0:
                time.sleep(min(left, 0.05))
            req = Request(uid=item["uid"],
                          tokens=prompt(run, item["uid"], item["plen"]),
                          max_new=item["n_out"], t_submit=due)
            engine.submit(req)
            late.append(time.monotonic() - due)
            live.append((item, req))
        end = deadline + float(tr["grace_s"])
        while time.monotonic() < end and not all(r.done for _, r in live):
            time.sleep(0.02)
    finally:
        stop.set()
        loop.join(TIMEOUT_S)
    recs = []
    for item, req in live:
        recs.append({"uid": item["uid"], "due": req.t_submit,
                     "plen": item["plen"],
                     "bucket": bucket_of(tr, item["plen"]),
                     "t_prefill": backend.prefill_start.get(id(req.tokens)),
                     "t_first": req.t_first_token or None,
                     "t_done": req.t_done if req.done else None,
                     "n_out": len(req.output) if req.done else 0,
                     "output": req.output if req.done else None,
                     "tokens": req.tokens})
    run.records["requests"] = recs
    run.attempted = len(recs)
    run.failed = sum(r["t_done"] is None for r in recs)
    run.window_end = max((r["t_done"] for r in recs if r["t_done"]),
                         default=time.monotonic())
    run.notes["generator_late_s"] = {"max": max(late, default=0.0),
                                     "median": float(np.median(late))
                                     if late else 0.0}
    print(f"generator lateness: {run.notes['generator_late_s']}",
          flush=True)


def sample(run) -> List[Dict[str, Any]]:
    """Finished requests the reference reads: the longest, then others
    drawn from the seed until ``check_tokens`` served tokens."""
    done = [r for r in run.records["requests"] if r["t_done"]]
    if not done:
        return []
    rng = random.Random(seeds.derive(run.seed, "check"))
    rng.shuffle(done)
    longest = max(done, key=lambda r: r["plen"] + r["n_out"])
    picked = [longest]
    for r in done:
        if sum(p["n_out"] for p in picked) >= run.traffic["check_tokens"]:
            break
        if r is not longest:
            picked.append(r)
    return picked


def release(run) -> None:
    for k in ("engine", "backend"):
        run.records.pop(k, None)
    import gc
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def served_logits(run, params, r, quant=None) -> torch.Tensor:
    """Reference logits at the positions that produced each served token
    of request r: its prompt left-padded to the bucket, then the served
    tokens but the last."""
    pad = r["bucket"] - r["plen"]
    seq = np.concatenate([np.zeros(pad, np.int32), r["tokens"],
                          r["output"][:-1]]).astype(np.int64)
    tok = torch.from_numpy(seq)[None].to(run.device)
    with torch.no_grad():
        x = hymba.hidden(run.config, params, tok, pad=pad, bucket=r["bucket"],
                         quant=quant)
        return hymba.logits(run.config, params,
                            x[:, r["bucket"] - 1:], quant)[0]


def gaps(run, picked, control: bool = False) -> float:
    """Widest gap by which a token lies below the reference's best logit:
    the served token (or, for the control, the float8 reference's first
    choice) at every checked position."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = hymba.init_params(run.config,
                                   seeds.derive(run.seed, "weights"),
                                   run.device)
        worst, each = 0.0, []
        for r in picked:
            ref = served_logits(run, params, r)
            if control:
                toks = served_logits(run, params, r, "fp8").argmax(-1)
            else:
                toks = torch.from_numpy(r["output"].astype(np.int64)).to(
                    ref.device)
            got = ref.gather(-1, toks[:, None])[:, 0]
            gap = float((ref.max(-1).values - got).max())
            each.append([r["uid"], r["bucket"], r["plen"], r["n_out"], gap])
            worst = max(worst, gap)
        run.notes["gap_by_request" + ("_control" if control else "")] = each
        return worst
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]


def check(run):
    picked = sample(run)
    run.notes["picked"] = picked
    release(run)
    if not picked:
        return [("served_checked", 0.0, -1.0)]
    run.notes["checked_tokens"] = sum(r["n_out"] for r in picked)
    t0 = time.monotonic()
    gap = gaps(run, picked)
    print(f"reference: {time.monotonic() - t0:.1f} s over "
          f"{len(picked)} requests, {run.notes['checked_tokens']} tokens",
          file=sys.stderr, flush=True)
    return [("logit_gap", gap, run.traffic["limits"]["logit_gap"])]


def control(run, kind: str = "fp8") -> Dict[str, float]:
    """The widest gap of the float8 reference's first choices, at the
    positions the check read."""
    return {"logit_gap": gaps(run, run.notes["picked"], control=True)}
