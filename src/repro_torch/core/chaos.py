"""Failure injection: kill chips, agents and whole pilots on a schedule.

The adversarial half of the fault-tolerance layer.  The paper's pilot
abstraction assumes HPC allocations vanish mid-run — walltime expiry,
node failure — and Hadoop answers with NodeManager liveness timeouts and
re-execution.  The :class:`FailureInjector` manufactures exactly those
deaths, deterministically, so the detection/recovery pipeline
(:meth:`~repro_torch.core.control_plane.ControlPlane.check_failures` →
``recover_pilot``) can be exercised and measured instead of trusted:

  * **chip kill** — ``pilot.fail_device``: the device leaves the RM pool
    and the agent re-queues impacted CUs per their retry budget.  The
    in-pilot recovery path; no ControlPlane involvement needed.
  * **agent kill** — :meth:`~repro_torch.core.agent.Agent.kill`: the agent
    process crashes.  Its scheduling loop and heartbeats stop abruptly;
    chips, replicas and queued CUs are stranded until the ControlPlane's
    heartbeat deadline declares the pilot DEAD and recovers them.
  * **pilot kill** — :meth:`~repro_torch.core.pilot.Pilot.kill`: the whole
    placeholder job disappears (node failure / walltime expiry).  Same
    detection path; recovery additionally reclaims the lease and
    rematerializes last-replica datasets.

Schedules are **seeded**: rate-driven mode draws per-tick Bernoulli
trials (Poisson approximation) from ``random.Random(seed)``, so the
*sequence* of kill decisions replays for a given seed; trace-driven mode
(``[(t_offset_s, kind, pilot_name_or_None)]``) replays timings too.
Every kill lands in :attr:`log` with a monotonic timestamp — paired with
the ControlPlane's ``failures`` events, that is the MTTR measurement
(:meth:`mttr_samples`).
"""
from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class KillEvent:
    """One injected failure (the injector side of the MTTR pairing)."""
    t: float                      # monotonic kill time
    kind: str                     # 'chip' | 'agent' | 'pilot'
    pilot: str                    # victim pilot uid
    detail: str = ""


class FailureInjector:
    KINDS = ("chip", "agent", "pilot")

    def __init__(self, pilots: Sequence, *, seed: int = 0,
                 chip_rate: float = 0.0, agent_rate: float = 0.0,
                 pilot_rate: float = 0.0,
                 trace: Optional[Sequence[Tuple[float, str,
                                                Optional[str]]]] = None,
                 min_pilots_alive: int = 1):
        """Rates are expected kills/second of each kind; ``trace`` is an
        explicit schedule of ``(t_offset_s, kind, pilot_name_or_None)``
        (None: the seeded RNG picks the victim).  ``min_pilots_alive``
        is the injector's blast-radius guard — it never kills an agent
        or pilot when that would leave fewer live pilots (chip kills
        are similarly refused on a pilot's last chip)."""
        self.pilots = list(pilots)
        self.rng = random.Random(seed)
        self.rates = {"chip": chip_rate, "agent": agent_rate,
                      "pilot": pilot_rate}
        self.trace = (sorted(trace, key=lambda e: e[0])
                      if trace is not None else None)
        self._trace_i = 0
        self.min_pilots_alive = min_pilots_alive
        self.log: List[KillEvent] = []
        self.errors: List[BaseException] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None

    # -------------------------------------------------------------- victims
    def _alive(self) -> List:
        """Pilots still worth killing: state ACTIVE and agent not
        already crashed (a killed-but-undetected pilot keeps state
        ACTIVE — the missed heartbeats are the only death signal)."""
        return [p for p in self.pilots
                if p.state.value == "active" and p.agent is not None
                and not getattr(p.agent, "_killed", False)]

    def _by_name(self, name: Optional[str]) -> Optional[List]:
        if name is None:
            return None
        return [p for p in self.pilots
                if p.desc.name == name or p.uid == name]

    def _record(self, kind: str, pilot, detail: str = "") -> KillEvent:
        ev = KillEvent(t=time.monotonic(), kind=kind, pilot=pilot.uid,
                       detail=detail)
        with self._lock:
            self.log.append(ev)
        return ev

    def kill_chip(self, pilot=None) -> Optional[KillEvent]:
        """Kill one device on ``pilot`` (default: a random live pilot
        with more than one chip — the last chip is never taken, so the
        pilot stays schedulable)."""
        cands = [p for p in (self._alive() if pilot is None else [pilot])
                 if len(p.devices) > 1]
        if not cands:
            return None
        p = self.rng.choice(cands)
        dev = self.rng.choice(p.devices)
        impacted = p.fail_device(dev)
        return self._record("chip", p, detail=f"impacted={len(impacted)}")

    def kill_agent(self, pilot=None) -> Optional[KillEvent]:
        """Crash a pilot's agent: loop, heartbeats and result
        publication stop; chips and data are stranded until the
        ControlPlane's heartbeat deadline fires."""
        p = self._pick_whole(pilot)
        if p is None:
            return None
        p.agent.kill()
        return self._record("agent", p)

    def kill_pilot(self, pilot=None) -> Optional[KillEvent]:
        """The whole pilot vanishes (node failure / walltime expiry):
        agent crash + staging pipeline stop.  Nothing is drained or
        released here — the loss is only visible through the missed
        heartbeats, exactly like a real node death."""
        p = self._pick_whole(pilot)
        if p is None:
            return None
        p.kill()
        return self._record("pilot", p)

    def _pick_whole(self, pilot) -> Optional[object]:
        """An agent/pilot-kill victim honoring ``min_pilots_alive`` —
        the floor binds even for an explicitly named victim."""
        alive = self._alive()
        if len(alive) <= self.min_pilots_alive:
            return None
        if pilot is not None:
            return pilot if pilot in alive else None
        return self.rng.choice(alive)

    # ------------------------------------------------------------- schedule
    def start(self, tick_s: float = 0.05) -> "FailureInjector":
        """Run the kill schedule on a daemon thread until :meth:`stop`
        (or, trace-driven, until the trace is exhausted)."""
        if self._thread is not None:
            return self
        self._t0 = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, args=(tick_s,),
                                        daemon=True, name="chaos-injector")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self, tick_s: float) -> None:
        while not self._stop.wait(tick_s):
            try:
                if not self._tick(tick_s):
                    return            # trace exhausted
            except BaseException as e:  # noqa: BLE001 — injector survives
                self.errors.append(e)

    def _tick(self, dt: float) -> bool:
        if self.trace is not None:
            elapsed = time.monotonic() - self._t0
            while (self._trace_i < len(self.trace)
                   and self.trace[self._trace_i][0] <= elapsed):
                _, kind, name = self.trace[self._trace_i]
                self._trace_i += 1
                self._fire(kind, name)
            return self._trace_i < len(self.trace)
        for kind, rate in self.rates.items():
            # P(at least one kill in dt) under a Poisson process
            if rate > 0 and self.rng.random() < -math.expm1(-rate * dt):
                self._fire(kind, None)
        return True

    def _fire(self, kind: str, name: Optional[str]) -> Optional[KillEvent]:
        if kind not in self.KINDS:
            raise ValueError(f"unknown kill kind {kind!r}; "
                             f"valid: {', '.join(self.KINDS)}")
        cands = self._by_name(name)
        victim = cands[0] if cands else None
        if name is not None and victim is None:
            raise KeyError(f"no pilot named {name!r} to kill")
        return {"chip": self.kill_chip, "agent": self.kill_agent,
                "pilot": self.kill_pilot}[kind](victim)

    # ------------------------------------------------------------ telemetry
    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {k: 0 for k in self.KINDS}
            for ev in self.log:
                out[ev.kind] += 1
            return out

    def mttr_samples(self, control_plane) -> List[float]:
        """Kill → recovery-complete durations: each whole-pilot kill
        (agent or pilot kind) paired with the first ControlPlane
        FailureEvent for the same pilot that completed after it.  Chip
        kills recover inside the agent (no ControlPlane event)."""
        by_pilot: Dict[str, List] = {}
        for f in control_plane.failures:
            by_pilot.setdefault(f.pilot, []).append(f)
        out = []
        with self._lock:
            kills = [k for k in self.log if k.kind != "chip"]
        for k in kills:
            ev = next((f for f in by_pilot.get(k.pilot, [])
                       if f.t_recovered >= k.t), None)
            if ev is not None:
                out.append(ev.t_recovered - k.t)
        return out
