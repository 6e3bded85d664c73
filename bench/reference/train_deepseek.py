"""Plain training steps of DeepSeek-V2 (``deepseek_v2``) to hold the
program's against: the same weights, the same batches, the next-token
loss plus ``moe_aux_alpha`` times the per-sequence balance loss, AdamW
with a clipped global gradient norm and a warm-up-cosine learning rate,
all in float32 with TF32 off and the weights kept in the configuration's
dtype between steps.

The batches and the schedule are ``train``'s (the token stream the
program's pipeline states, from the vocabulary the configuration
holds).  Rows are taken ``rows`` at a time, so the reference fits beside
nothing else on the card: each block adds its rows' NLL over the whole
batch's token count and its sequences' share of the balance loss.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from . import deepseek_v2 as ds
from .train import _tree, batch_at, lr_scale  # noqa: F401


def loss_sum(cfg: Dict, P, tokens, labels, fault: Optional[str],
             chunk: int = 512):
    """(summed next-token NLL of the rows, the balance loss averaged over
    these rows' sequences, summed over the layers); logits over the real
    vocabulary chunk by chunk of the sequence."""
    x, aux = ds.hidden(cfg, P, tokens, fault=fault, remat=True)
    tot = x.new_zeros(())
    for lo in range(0, x.shape[1], chunk):
        def nll(xc, lc):
            lg = ds.logits(cfg, P, xc, fault)
            return (torch.logsumexp(lg, -1)
                    - lg.gather(-1, lc.long()[..., None])[..., 0]).sum()
        tot = tot + torch.utils.checkpoint.checkpoint(
            nll, x[:, lo:lo + chunk], labels[:, lo:lo + chunk],
            use_reentrant=False)
    return tot, aux


def steps(cfg: Dict, params, batches: List[Dict[str, Any]],
          hyper: Dict[str, float], *, rows: int,
          fault: Optional[str] = None) -> Dict[str, Any]:
    """Run len(batches) steps from `params` (changed in place).  Returns
    each step's loss, the gradient as the optimizer gets it after the
    first step (clipped, per leaf norm) and each leaf's change over all
    the steps (norm), by leaf path."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _steps(cfg, params, batches, hyper, rows, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.backends.cudnn.allow_tf32 = keep[1]


def _steps(cfg, params, batches, hyper, rows, fault):
    named = list(ds.leaves(params))
    start = {ds.path_name(p): t.clone() for p, t in named}
    m = {ds.path_name(p): torch.zeros_like(t, dtype=torch.float32)
         for p, t in named}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    alpha = cfg["moe_aux_alpha"]
    losses, first_grad = [], {}
    b1, b2 = hyper["b1"], hyper["b2"]
    for step, batch in enumerate(batches):
        f32 = {ds.path_name(p):
               t.detach().to(torch.float32, copy=True).requires_grad_(True)
               for p, t in named}
        tree = _tree(params, f32)
        dev = next(iter(f32.values())).device
        tok = torch.from_numpy(batch["tokens"]).to(dev)
        lab = torch.from_numpy(batch["labels"]).to(dev)
        count, n_rows = tok.numel(), tok.shape[0]
        total = 0.0
        for lo in range(0, n_rows, rows):
            nll, aux = loss_sum(cfg, tree, tok[lo:lo + rows],
                                lab[lo:lo + rows], fault)
            part = nll / count + alpha * aux * (min(rows, n_rows - lo)
                                                / n_rows)
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
                k = ds.path_name(path)
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
              for k, p in ((ds.path_name(q), t) for q, t in named)}
    return {"losses": losses, "first_grad": first_grad, "change": change}
