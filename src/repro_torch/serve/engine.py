"""Continuous-batching serving engine.

The port of ``repro.serve.engine``: the framework's serving CU kind, a
request queue feeding a fixed-width decode batch.  Requests join
mid-flight as slots free up (continuous batching) — prefill for a
joining request runs while other slots keep decoding; per-slot positions
live in the host-side ``pos`` vector.

Correctness: prompts are left-padded into fixed buckets, with a pad mask
during prefill and a per-slot ``start`` vector during decode, so pad
tokens are never attended and RoPE runs at pad-relative positions (see
``transformer.prefill``; Mamba layers have no pad mask, in the reference
too).  A slot that is reused gets its whole cache row rewritten, so no
row of the previous request survives past the new prompt.

Throughput: the decode loop does ONE device→host sync per step (the
sampled token vector); positions, remaining-token counts and finish
detection are vectorized NumPy on the host.  Admission drains a deque
in one pass per round, and the drain loop blocks on the intake queue
when idle instead of busy-spinning.

Disaggregation: the model work lives behind a small backend interface
(``prefill`` / ``splice`` / ``step``), so prefill can run elsewhere —
e.g. as a Raptor micro-task on a compute-heavy pilot — and enter
through :meth:`ServeEngine.submit_prefilled` with its cache in hand
(serve/router.py routes those by KV locality).  Every thread launches on
the device's current stream, so a cache prefilled on an overlay thread
is ordered before its splice on an engine thread.
:class:`SimBackend` models the per-step costs without a real model for
scale benchmarks.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.util import Device, resolve_device


@dataclasses.dataclass(eq=False)      # identity eq: the auto __eq__ would
class Request:                        # compare ndarray fields (ambiguous
    uid: int                          # truth value in membership tests)
    tokens: np.ndarray            # prompt token ids (1-D)
    max_new: int = 16
    done: bool = False
    output: Optional[np.ndarray] = None
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    tenant: str = "default"       # admission-budget key (multi-tenant serving)
    kv_bytes: int = 0             # KV-page bytes leased (DRF's second axis)


@dataclasses.dataclass
class PrefillResult:
    """A finished prefill, ready to splice into a decode slot."""
    caches: Any                   # single-request caches (backend-defined)
    next_tok: int                 # argmax of the last-position logits
    bucket: int                   # padded prompt length (initial pos)
    pad: int                      # left-pad count (the slot's `start`)


# ---------------------------------------------------------------- backends
class ModelBackend:
    """Real-model backend: bucketed prefill + batched decode through the
    serving steps, on `device` (default the card).

    It keeps the caller's `params` tensors: every backend made from one
    params tree shares one copy of the weights.  It cannot be pickled,
    so a Raptor micro-task carrying its bound ``prefill`` passes it by
    reference instead of copying the weights to the host."""

    def __init__(self, cfg: ModelConfig, params, *, device: Device = "cuda"):
        if cfg.frontend != "none" or cfg.is_encoder_decoder:
            raise ValueError("the continuous batching engine supports plain "
                             f"LM archs, not {cfg.name!r}")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self._decode = make_decode_step(cfg, sample=True)
        self._prefill = make_prefill_step(cfg)

    def __reduce__(self):
        raise TypeError("ModelBackend holds the model's weights and is not "
                        "picklable; pass it by reference")

    def make_state(self, slots: int, max_seq: int) -> Dict[str, Any]:
        with torch.inference_mode():
            return {"caches": transformer.init_caches(
                        self.cfg, slots, max_seq, device=self.device),
                    "cur_tok": torch.zeros((slots, 1), dtype=torch.int32,
                                           device=self.device),
                    "max_seq": max_seq}

    def prefill(self, tokens: np.ndarray, bucket: int) -> PrefillResult:
        """Left-pad to `bucket`, mask the pad, RoPE at pad-relative
        positions.  Thread-safe: runs on overlay workers in the
        disaggregated path."""
        plen = len(tokens)
        pad = bucket - plen
        padded = np.zeros((1, bucket), np.int32)
        padded[0, pad:] = tokens
        slots = torch.arange(bucket, dtype=torch.int32, device=self.device)
        batch = {"tokens": torch.from_numpy(padded).to(self.device),
                 "positions": slots - pad, "pad_mask": slots >= pad}
        caches, logits = self._prefill(self.params, batch)
        nxt = int(torch.argmax(logits[0, -1, : self.cfg.vocab_size]))
        return PrefillResult(caches=caches, next_tok=nxt, bucket=bucket,
                             pad=pad)

    def splice(self, state: Dict[str, Any], slot: int,
               pre: PrefillResult) -> None:
        """Write the slot's whole cache row: zeros, then the
        single-request cache at its front (the reference pads it with
        zeros to the max_seq shape and sets the row)."""
        with torch.inference_mode():
            for full, one in zip(state["caches"], pre.caches):
                for k, buf in full.items():
                    row = buf[:, slot]
                    src = one[k][:, 0]
                    row.zero_()
                    row[tuple(slice(0, n) for n in src.shape)].copy_(src)
            state["cur_tok"][slot, 0] = pre.next_tok

    def step(self, state: Dict[str, Any], pos: np.ndarray,
             start: np.ndarray) -> np.ndarray:
        """One decode step for the whole batch; returns the sampled
        token per slot (the step's single device→host sync)."""
        caches, _, nxt = self._decode(
            self.params, state["caches"], state["cur_tok"],
            torch.tensor(pos, dtype=torch.int32, device=self.device),
            torch.tensor(start, dtype=torch.int32, device=self.device))
        state["caches"] = caches
        state["cur_tok"] = nxt
        return nxt[:, 0].cpu().numpy()


class SimBackend:
    """Modeled-cost backend for scale benchmarks: prefill/decode are
    timed sleeps, tokens are a deterministic hash — so a 10³-user sweep
    measures scheduling, placement and batching, not model FLOPs."""

    def __init__(self, *, prefill_s: float = 1.5e-3,
                 prefill_s_per_token: float = 0.0,
                 step_s: float = 8e-4, vocab: int = 1024):
        self.prefill_s = prefill_s
        self.prefill_s_per_token = prefill_s_per_token
        self.step_s = step_s
        self.vocab = vocab

    def make_state(self, slots: int, max_seq: int) -> Dict[str, Any]:
        return {"tok": np.zeros(slots, np.int64), "max_seq": max_seq}

    def prefill(self, tokens: np.ndarray, bucket: int) -> PrefillResult:
        time.sleep(self.prefill_s + self.prefill_s_per_token * len(tokens))
        nxt = int(tokens[-1]) % self.vocab if len(tokens) else 0
        return PrefillResult(caches=None, next_tok=nxt, bucket=bucket,
                             pad=bucket - len(tokens))

    def splice(self, state, slot: int, pre: PrefillResult) -> None:
        state["tok"][slot] = pre.next_tok

    def step(self, state, pos: np.ndarray, start: np.ndarray) -> np.ndarray:
        time.sleep(self.step_s)
        state["tok"] = (state["tok"] * 1103515245 + 12345) % self.vocab
        return state["tok"].copy()


# --------------------------------------------------------------- admission
class AdmissionControl:
    """Picks which waiting requests join free slots this round.

    ``plan`` may charge shared accounting for what it returns;
    ``release`` undoes it when the request finishes.  The base class is
    unconditioned FIFO."""

    def plan(self, waiting: List[Request], n_free: int,
             engine: "ServeEngine") -> List[Request]:
        return waiting[:n_free]

    def release(self, req: Request, engine: "ServeEngine") -> None:
        pass

    def admissible_ever(self, req: Request) -> bool:
        """Intake-time rejection hook (a request that could NEVER be
        admitted must not wedge run_until_drained)."""
        return True


class StaticBudgetAdmission(AdmissionControl):
    """Per-engine slot caps by tenant: a tenant at budget is skipped —
    later requests from other tenants join ahead of it — so one tenant's
    flood cannot monopolize the batch."""

    def __init__(self, tenant_budget: Optional[Dict[str, int]] = None,
                 default_budget: Optional[int] = None):
        self.tenant_budget = tenant_budget
        self.default_budget = default_budget

    def budget_of(self, tenant: str) -> Optional[int]:
        if self.tenant_budget is not None and tenant in self.tenant_budget:
            return self.tenant_budget[tenant]
        return self.default_budget

    def admissible_ever(self, req: Request) -> bool:
        budget = self.budget_of(req.tenant)
        return budget is None or budget > 0

    def plan(self, waiting, n_free, engine):
        counts: Dict[str, int] = {}
        for r in engine.active:
            if r is not None:
                counts[r.tenant] = counts.get(r.tenant, 0) + 1
        chosen: List[Request] = []
        for req in waiting:
            if len(chosen) >= n_free:
                break
            budget = self.budget_of(req.tenant)
            if budget is None or counts.get(req.tenant, 0) < budget:
                chosen.append(req)
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
        return chosen


# ------------------------------------------------------------------ engine
class ServeEngine:
    def __init__(self, cfg: Optional[ModelConfig] = None, params=None, *,
                 backend=None, slots: int = 4, max_seq: int = 256,
                 prompt_bucket: int = 32,
                 tenant_budget: Optional[Dict[str, int]] = None,
                 default_tenant_budget: Optional[int] = None,
                 admission: Optional[AdmissionControl] = None,
                 name: str = "serve0"):
        """``backend`` defaults to a :class:`ModelBackend` over
        (cfg, params) on the card.  ``admission`` defaults to the static per-tenant
        slot budgets (``tenant_budget`` / ``default_tenant_budget``);
        pass a shared policy (e.g. the router's DRF admission) to
        enforce budgets across engines.  With neither, admission is
        strictly FIFO — exactly the pre-tenant behavior."""
        if backend is None:
            backend = ModelBackend(cfg, params)
        self.backend = backend
        self.cfg = cfg
        self.name = name
        self.slots = slots
        self.max_seq = max_seq
        self.bucket = prompt_bucket
        self.admission = admission or StaticBudgetAdmission(
            tenant_budget, default_tenant_budget)
        self.queue: "queue.Queue[Tuple[Request, Optional[PrefillResult]]]" \
            = queue.Queue()
        # arrival-ordered admission line: one-pass deque + uid index (no
        # list.remove scans); items are (request, optional prefill)
        self._waiting: Deque[Tuple[Request, Optional[PrefillResult]]] = deque()
        self._waiting_uids: set = set()
        self.state = backend.make_state(slots, max_seq)
        self.pos = np.zeros(slots, np.int32)       # host-side: no device
        self.start = np.zeros(slots, np.int32)     # syncs for bookkeeping
        self.remaining = np.zeros(slots, np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.outputs: Dict[int, List[int]] = {}
        self.on_finish: Optional[Callable[[Request], None]] = None
        self.steps = 0
        self.admitted = 0
        self.decoded_tokens = 0

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        """Raw-request intake: prefill runs inline at admission time
        (the single-pilot path)."""
        if not self.admission.admissible_ever(req):
            # a zero budget means blocked, not "one slot anyway"; reject
            # at intake so the request cannot wedge run_until_drained
            raise PermissionError(
                f"tenant {req.tenant!r} has a zero slot budget")
        if not req.t_submit:
            req.t_submit = time.monotonic()
        self.queue.put((req, None))

    def submit_prefilled(self, req: Request, pre: PrefillResult) -> None:
        """Disaggregated intake: the prompt was prefilled elsewhere
        (router → Raptor micro-task on the compute pilot); only the
        splice + decode run here."""
        if not req.t_submit:
            req.t_submit = time.monotonic()
        self.queue.put((req, pre))

    # ---------------------------------------------------------- admission
    def _drain_intake(self) -> None:
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                return
            self._waiting.append(item)
            self._waiting_uids.add(item[0].uid)

    def _admit(self) -> None:
        self._drain_intake()
        free = [s for s in range(self.slots) if self.active[s] is None]
        if not free or not self._waiting:
            return
        chosen = self.admission.plan([r for r, _ in self._waiting],
                                     len(free), self)
        if not chosen:
            return
        chosen_ids = {id(r) for r in chosen}
        picked: Dict[int, Tuple[Request, Optional[PrefillResult]]] = {}
        kept: Deque[Tuple[Request, Optional[PrefillResult]]] = deque()
        for item in self._waiting:           # one O(n) pass, order kept
            if id(item[0]) in chosen_ids:
                picked[id(item[0])] = item
            else:
                kept.append(item)
        self._waiting = kept
        for req in chosen:
            self._waiting_uids.discard(req.uid)
            slot = free.pop()
            self._place(slot, *picked[id(req)])

    def _bucket_for(self, plen: int) -> int:
        return min(self.max_seq,
                   ((plen + self.bucket - 1) // self.bucket) * self.bucket)

    def _place(self, slot: int, req: Request,
               pre: Optional[PrefillResult]) -> None:
        if pre is None:
            pre = self.backend.prefill(req.tokens,
                                       self._bucket_for(len(req.tokens)))
        self.backend.splice(self.state, slot, pre)
        self.pos[slot] = pre.bucket
        self.start[slot] = pre.pad
        self.remaining[slot] = req.max_new - 1
        self.active[slot] = req
        self.outputs[req.uid] = [pre.next_tok]
        self.admitted += 1
        req.t_first_token = time.monotonic()

    # -------------------------------------------------------------- decode
    def _step(self) -> None:
        mask = np.array([a is not None for a in self.active])
        if not mask.any():
            return
        toks = self.backend.step(self.state, self.pos, self.start)
        self.steps += 1
        self.pos[mask] += 1
        self.remaining[mask] -= 1
        self.decoded_tokens += int(mask.sum())
        finished = mask & ((self.remaining <= 0)
                           | (self.pos >= self.max_seq - 1))
        for slot in np.nonzero(mask)[0]:
            self.outputs[self.active[slot].uid].append(int(toks[slot]))
        for slot in np.nonzero(finished)[0]:
            self._finish(int(slot))

    def _finish(self, slot: int) -> None:
        req = self.active[slot]
        req.output = np.asarray(self.outputs.pop(req.uid), np.int32)
        req.done = True
        req.t_done = time.monotonic()
        self.active[slot] = None
        self.admission.release(req, self)
        cb = self.on_finish
        if cb is not None:
            cb(req)

    # ------------------------------------------------------------ recovery
    def evacuate(self) -> List[Tuple[Request, Optional[PrefillResult]]]:
        """Failure recovery: this engine's pilot died.  Hand back every
        request that has not finished — waiting ones with their prefill
        (reusable if its KV survives), active ones with ``None`` (their
        decode state died with the pilot; they re-prefill elsewhere).
        Active requests release their admission charge here; waiting
        ones were never charged.  The caller (router) must have stopped
        the engine's serve loop first."""
        self._drain_intake()
        out: List[Tuple[Request, Optional[PrefillResult]]] = list(self._waiting)
        self._waiting = deque()
        self._waiting_uids = set()
        for slot in range(self.slots):
            req = self.active[slot]
            if req is None:
                continue
            self.active[slot] = None
            self.remaining[slot] = 0
            self.outputs.pop(req.uid, None)
            self.admission.release(req, self)
            out.append((req, None))
        return out

    # ----------------------------------------------------------------- run
    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.active)

    @property
    def backlog(self) -> int:
        """Requests not yet decoding — the engine's pressure signal."""
        return self.queue.qsize() + len(self._waiting)

    def snapshot(self) -> Dict[str, Any]:
        """Heartbeat export (status["serve"])."""
        return {"name": self.name, "slots": self.slots,
                "active": self.n_active, "waiting": self.backlog,
                "steps": self.steps, "admitted": self.admitted,
                "decoded_tokens": self.decoded_tokens}

    def _idle_wait(self, timeout: float) -> None:
        """Block on intake instead of busy-spinning when slots are empty."""
        try:
            item = self.queue.get(timeout=max(timeout, 1e-3))
        except queue.Empty:
            return
        self._waiting.append(item)
        self._waiting_uids.add(item[0].uid)

    def _drain_diagnostic(self, timeout_s: float) -> str:
        self._drain_intake()
        by_tenant: Dict[str, List[int]] = {}
        for req, _ in self._waiting:
            by_tenant.setdefault(req.tenant, []).append(req.uid)
        waiting = "; ".join(
            f"tenant {t!r}: {len(uids)} waiting (uids {uids[:8]})"
            for t, uids in sorted(by_tenant.items())) or "none"
        running = [f"{r.tenant}/{r.uid}" for r in self.active
                   if r is not None]
        return (f"serve engine {self.name!r}: queue not drained after "
                f"{timeout_s:.0f}s — waiting: {waiting}; "
                f"active slots: {running or 'none'}")

    def run_until_drained(self, timeout_s: float = 300.0,
                          idle_wait_s: float = 0.02) -> int:
        """Serve until queue + slots are empty. Returns decode steps run.

        On timeout the error names the tenants/requests still waiting —
        a tenant whose budget can never clear shows up by name instead
        of as a bare TimeoutError."""
        t0 = time.monotonic()
        while True:
            self._admit()
            if self.n_active:
                self._step()
            elif self.queue.empty() and not self._waiting:
                return self.steps
            else:
                self._idle_wait(min(idle_wait_s,
                                    timeout_s - (time.monotonic() - t0)))
            if time.monotonic() - t0 >= timeout_s:
                raise TimeoutError(self._drain_diagnostic(timeout_s))

    def run_forever(self, stop: threading.Event,
                    idle_wait_s: float = 0.01) -> int:
        """Long-lived serve loop (the gang-CU body in the disaggregated
        deployment): decode while slots are active, block briefly on
        intake otherwise, exit when `stop` is set."""
        while not stop.is_set():
            self._admit()
            if self.n_active:
                self._step()
            else:
                self._idle_wait(idle_wait_s)
        return self.steps
