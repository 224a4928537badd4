"""Straggler detection + mitigation for 1000+-node training.

On a synchronous SPMD cluster the step time is the MAX over hosts, so one
slow host (thermal throttle, ECC retirement, flaky NIC) drags the fleet.
The detector keeps per-host EWMA step-time statistics; hosts persistently
slower than ``threshold`` x the fleet median are flagged.  Mitigations are
policy callbacks the launcher wires up:

  * ``report``   — log and export (dashboards / alerting);
  * ``exclude``  — drop the host at the next boundary (the serving
                   fleet's ``exclude_stragglers`` loses its device);
  * ``restart``  — ask the cluster manager to reschedule the host.

The detector is pure-host-side bookkeeping (no device code), so the train
loop calls ``observe(host_id, step_seconds)`` with timings it already has —
in a real deployment from a heartbeat service; in tests, synthetically.
The serving fleet (``repro_torch.serve.fleet``) uses it with host ==
device worker.

Cold-start contract: the first observation *seeds* the EWMA (no zero-mix
warmup bias), and a fleet needs at least two observed hosts before anyone
can be flagged — a single host has no fleet to be slower than, and its
median tracks its own EWMA, so self-flagging on a spike would only ever
exclude the entire (one-host) fleet.

Pass ``metrics=`` (a ``repro_torch.obs.metrics.Registry``) to mirror every
``on_straggler`` event onto ``straggler.flagged{host=...}`` counters and
a ``straggler.flagged_total`` counter, so dashboards see exclusions
without wiring a callback.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class HostStat:
    ewma: float = 0.0
    var_ewma: float = 0.0
    last: float = 0.0
    count: int = 0
    slow_streak: int = 0


class StragglerDetector:
    """Flags hosts whose EWMA step time exceeds threshold x fleet median."""

    def __init__(self, num_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 1.25, patience: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None,
                 metrics=None):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self.metrics = metrics
        self.stats = [HostStat() for _ in range(num_hosts)]
        self.flagged: set[int] = set()

    def observe(self, host_id: int, step_seconds: float) -> None:
        s = self.stats[host_id]
        s.last = step_seconds
        if s.count == 0:
            s.ewma = step_seconds
        else:
            d = step_seconds - s.ewma
            s.ewma += self.alpha * d
            s.var_ewma = (1 - self.alpha) * (s.var_ewma + self.alpha * d * d)
        s.count += 1

    def observe_step(self, timings: dict[int, float]) -> set[int]:
        """Feed one synchronous step's per-host timings; returns new flags."""
        for h, t in timings.items():
            self.observe(h, t)
        return self.evaluate()

    def fleet_median(self) -> float:
        vals = sorted(s.ewma for s in self.stats if s.count > 0)
        if not vals:
            return 0.0
        n = len(vals)
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])

    def evaluate(self) -> set[int]:
        """Update slow-streaks; flag hosts slow for ``patience`` CONSECUTIVE
        observations.  Streaks count the instantaneous observation (a single
        GC-pause blip must not flag via its lingering EWMA); the EWMA backs
        the reported magnitude and z-scores."""
        med = self.fleet_median()
        observed = sum(1 for s in self.stats if s.count > 0)
        if med <= 0 or observed < 2:
            # A one-host "fleet" compares a host against its own EWMA —
            # a single spike could flag (and exclude) the whole fleet.
            return set()
        new = set()
        for h, s in enumerate(self.stats):
            if s.count == 0:
                continue
            if s.last > self.threshold * med:
                s.slow_streak += 1
            else:
                s.slow_streak = 0
                self.flagged.discard(h)
            if s.slow_streak >= self.patience and h not in self.flagged:
                self.flagged.add(h)
                new.add(h)
                if self.on_straggler:
                    self.on_straggler(h, s.ewma, med)
                if self.metrics is not None:
                    self.metrics.counter('straggler.flagged', host=h).inc()
                    self.metrics.counter('straggler.flagged_total').inc()
        return new

    def zscore(self, host_id: int) -> float:
        s = self.stats[host_id]
        med = self.fleet_median()
        sd = math.sqrt(max(s.var_ewma, 1e-12))
        return (s.ewma - med) / sd if s.count else 0.0

    def healthy_hosts(self) -> list[int]:
        return [h for h in range(self.num_hosts) if h not in self.flagged]
