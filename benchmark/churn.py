"""Lane churn for a batched server: callers join lanes, and producers are
sometimes late.

Every lane holds a caller on every tick, as in an N-stream throughput
measurement, so the work of a tick does not depend on the seed.  Joins and
pauses are there for the lane masks, which the check holds to the
reference, at rates stated in the traffic file and not drawn from any
model of callers:

* a lane's caller is replaced every ``call_s`` seconds of audio (a join:
  its tick carries the reset mask, and the new caller reads another signal
  from another place); the lanes' phases are spread evenly by the seed, so
  the same number of lanes (within one) joins on every tick, and every
  lane joins on tick 0;
* on every tick exactly ``round(pause_share * lanes)`` lanes, drawn by the
  seed among those not joining, are paused (none on tick 0, where every
  lane joins; the chunk is late: the lane
  does not advance, and its audio resumes where it stopped).

The schedule depends on the tick index only, never on timing, so a shorter
window sees a prefix of the same ticks.
"""

from __future__ import annotations

import numpy as np


class Churn:
    """Ticks of a closed-loop batched server: :meth:`tick` returns
    ``(live [N] bool, reset [N] bool, sig [N] int, pos [N] int)``: lane i's
    chunk is samples ``pos[i] : pos[i] + S`` of pool signal ``sig[i]``
    (positions wrap at ``length``)."""

    def __init__(self, traffic: dict, chunk_s: float, S: int, length: int,
                 signals: int, seed_entropy):
        self.N = int(traffic["lanes"])
        self.S, self.length, self.signals = S, length, signals
        self.rng = np.random.default_rng(seed_entropy)
        self.call = max(1, round(traffic["call_s"] / chunk_s))
        self.pauses = round(float(traffic["pause_share"]) * self.N)
        # lane i's caller changes at ticks phase[i] + k * call, k >= 0
        self.phase = 1 + self.rng.permutation(self.N) * self.call // self.N
        self.sig = self.rng.integers(0, signals, self.N)
        self.pos = self.rng.integers(0, length, self.N)
        self.t = 0

    def tick(self):
        t, N = self.t, self.N
        if t == 0:
            reset = np.ones(N, bool)
        else:
            reset = (t >= self.phase) & ((t - self.phase) % self.call == 0)
            joining = np.flatnonzero(reset)
            self.sig[joining] = self.rng.integers(0, self.signals,
                                                  len(joining))
            self.pos[joining] = self.rng.integers(0, self.length,
                                                  len(joining))
        live = np.ones(N, bool)
        cand = np.flatnonzero(~reset)          # none on tick 0
        k = min(self.pauses, len(cand))
        if k:
            live[self.rng.choice(cand, k, replace=False)] = False
        pos = self.pos.copy()
        self.pos = np.where(live, (self.pos + self.S) % self.length,
                            self.pos)
        self.t += 1
        return live, reset, self.sig.copy(), pos
