"""Plain training steps to hold the program's against: the same weights,
the same batches, the next-token loss, AdamW with a clipped global
gradient norm and a warm-up-cosine learning rate, all in float32 with
the weights kept in the configuration's dtype between steps.

The batches are worked out again from the data seed by the token stream
the program's pipeline states (per row a start and a stride drawn by
``numpy.random.default_rng((seed, step))``, tokens ``(start + stride t)
mod vocab``); nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import hymba


def batch_at(cfg: Dict, seed: int, step: int, batch: int, seq: int
             ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, step))
    start = rng.integers(0, cfg["vocab_size"], (batch, 1))
    stride = rng.integers(1, 4, (batch, 1))
    t = np.arange(seq + 1)[None, :]
    tokens = ((start + stride * t) % cfg["vocab_size"]).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def lr_scale(step: int, warmup: int, total: int, floor: float = 0.1
             ) -> float:
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi
                                                                 * frac)))


def loss_sum(cfg: Dict, P, tokens, labels, quant, chunk: int = 512):
    """Summed next-token NLL of the rows, logits over the real vocabulary
    computed chunk by chunk of the sequence."""
    x = hymba.hidden(cfg, P, tokens, quant=quant, remat=True)
    tot = x.new_zeros(())
    for lo in range(0, x.shape[1], chunk):
        def nll(xc, lc):
            lg = hymba.logits(cfg, P, xc, quant)
            return (torch.logsumexp(lg, -1)
                    - lg.gather(-1, lc.long()[..., None])[..., 0]).sum()
        tot = tot + torch.utils.checkpoint.checkpoint(
            nll, x[:, lo:lo + chunk], labels[:, lo:lo + chunk],
            use_reentrant=False)
    return tot


def steps(cfg: Dict, params, batches: List[Dict[str, np.ndarray]],
          hyper: Dict[str, float], *, rows: int,
          quant: Optional[str] = None) -> Dict[str, Any]:
    """Run len(batches) steps from `params` (changed in place).  Returns
    each step's loss, the gradient as the optimizer gets it after the
    first step (clipped, per leaf norm) and each leaf's change over all
    the steps (norm), by leaf path."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(cfg, params, batches, hyper, rows, quant)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]


def _steps(cfg, params, batches, hyper, rows, quant):
    named = list(hymba.leaves(params))
    start = {hymba.path_name(p): t.clone() for p, t in named}
    m = {hymba.path_name(p): torch.zeros_like(t, dtype=torch.float32)
         for p, t in named}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    losses, first_grad = [], {}
    b1, b2 = hyper["b1"], hyper["b2"]
    for step, batch in enumerate(batches):
        # float32 leaves to differentiate, rebuilt each step from the
        # stored weights
        f32 = {hymba.path_name(p):
               t.detach().to(torch.float32, copy=True).requires_grad_(True)
               for p, t in named}
        tree = _tree(params, f32)
        dev = next(iter(f32.values())).device
        tok = torch.from_numpy(batch["tokens"]).to(dev)
        lab = torch.from_numpy(batch["labels"]).to(dev)
        count = tok.numel()
        total = 0.0
        for lo in range(0, tok.shape[0], rows):
            part = loss_sum(cfg, tree, tok[lo:lo + rows], lab[lo:lo + rows],
                            quant) / count
            part.backward()
            total += float(part.detach())
        losses.append(total)
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in f32.items()}
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = min(1.0, hyper["clip_norm"] / max(float(gnorm), 1e-9))
        bc1, bc2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
        lr = hyper["lr"] * lr_scale(step, hyper["warmup_steps"],
                                    hyper["total_steps"])
        with torch.no_grad():
            for (path, p) in named:
                k = hymba.path_name(path)
                g = grads[k] * scale
                if step == 0:
                    first_grad[k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + hyper["eps"]) \
                    + hyper["weight_decay"] * p.float()
                p.copy_(p.float() - lr * delta)
        del f32, tree, grads
    change = {k: float((p.float() - start[k].float()).norm())
              for k, p in ((hymba.path_name(q), t) for q, t in named)}
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _tree(like, flat: Dict[str, torch.Tensor], prefix=()):
    if isinstance(like, dict):
        return {k: _tree(like[k], flat, prefix + (k,)) for k in like}
    if isinstance(like, (list, tuple)):
        return [_tree(x, flat, prefix + (i,)) for i, x in enumerate(like)]
    return flat[hymba.path_name(prefix)]
