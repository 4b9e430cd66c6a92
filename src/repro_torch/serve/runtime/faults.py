"""Deterministic fault injection for the serving runtime (chaos harness).

The runtime's robustness claims — "an engine fault fails only its own
batch", "a tripped breaker degrades to the exact path", "a corrupt file
can never serve under its old digest" — are only claims until a test can
MAKE those things happen on demand, repeatably. This module is the
demand side: one ``FaultInjector`` threaded (optionally) through the
batcher and the registry, producing faults that are a pure function of
``(seed, site, check ordinal)`` — never of wall-clock time or thread
scheduling — so a failing chaos run replays exactly.

Sites (the strings the runtime consults):

  * ``"engine_step"``   — consulted by ``MicroBatcher`` immediately
    before the coalesced engine submit; a fault raises ``InjectedFault``
    (the batch fails, the worker must survive), a slow verdict sleeps
    ``slow_step_s`` first (deadline/overload pressure without faulting).
  * ``"registry_load"`` — consulted by ``ArtifactRegistry`` before
    (re)loading an artifact from disk; a fault raises ``InjectedFault``
    (transient load failure: the entry is NOT quarantined and the next
    resolve retries).
  * ``"engine_step#<i>"`` — the replica-scoped variant a multi-replica
    ``MicroBatcher`` consults via ``check_replica``: scripted verdicts
    for replica ``i`` only (fault-isolation tests trip ONE replica's
    breaker while its siblings keep serving). Replica sites are
    scripted-only — when nothing is queued for the replica site the
    check falls through to the base site, so seeded rates behave
    identically whether a model runs 1 replica or N.

Two ways to schedule faults, composable:

  * **scripted** — ``fail_next(site, n)`` / ``slow_next(site, n)`` queue
    exact outcomes for the next n checks (chaos tests that need "the
    next 3 engine steps fail, then recovery");
  * **seeded rates** — ``engine_fault_rate`` etc. draw from a per-site
    ``np.random.default_rng`` sequence: the k-th check of a site gets
    the same verdict for the same seed in every run and every process.

``corrupt_file`` / ``truncate_file`` are the disk-side counterpart:
deterministic (seeded) byte flips / truncation for artifact files, used
to exercise the registry's ``ArtifactCorrupt`` quarantine path.

Counters (``snapshot()``) record checks/faults/slows per site so a chaos
test can assert the harness actually fired — a chaos suite whose faults
silently never trigger is worse than no suite at all.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib

import numpy as np

from repro_torch.serve.runtime.errors import InjectedFault

ENGINE_STEP = "engine_step"
REGISTRY_LOAD = "registry_load"


class FaultInjector:
    """Deterministic, seeded fault source for runtime chaos tests."""

    def __init__(
        self,
        seed: int = 0,
        *,
        engine_fault_rate: float = 0.0,
        slow_step_rate: float = 0.0,
        slow_step_s: float = 0.005,
        registry_load_fail_rate: float = 0.0,
        sleep=time.sleep,
    ):
        self.seed = int(seed)
        self.slow_step_s = float(slow_step_s)
        self._sleep = sleep
        self._rates = {
            ENGINE_STEP: float(engine_fault_rate),
            REGISTRY_LOAD: float(registry_load_fail_rate),
        }
        self._slow_rates = {ENGINE_STEP: float(slow_step_rate)}
        self._rngs: dict[str, np.random.Generator] = {}
        self._scripts: dict[str, collections.deque] = {}
        self._counts: dict[str, dict] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- scheduling

    def fail_next(self, site: str, n: int = 1) -> None:
        """Script the next ``n`` checks of ``site`` to raise."""
        with self._lock:
            self._scripts.setdefault(site, collections.deque()).extend(
                ["fault"] * n
            )

    def slow_next(self, site: str, n: int = 1) -> None:
        """Script the next ``n`` checks of ``site`` to sleep first."""
        with self._lock:
            self._scripts.setdefault(site, collections.deque()).extend(
                ["slow"] * n
            )

    def pass_next(self, site: str, n: int = 1) -> None:
        """Script the next ``n`` checks of ``site`` to pass (overrides
        the seeded rates — lets a test pin a recovery probe's outcome)."""
        with self._lock:
            self._scripts.setdefault(site, collections.deque()).extend(
                ["pass"] * n
            )

    def clear_scripts(self, site: str | None = None) -> None:
        """Drop queued scripted verdicts for ``site`` (or every site):
        the end-of-scenario reset for tests that over-provision a script
        (e.g. "slow everything during this burst") and need the next
        scenario to start from the seeded rates alone."""
        with self._lock:
            if site is None:
                self._scripts.clear()
            else:
                self._scripts.pop(site, None)

    # --------------------------------------------------------------- checking

    def _verdict_locked(self, site: str) -> str:
        script = self._scripts.get(site)
        if script:
            return script.popleft()
        # per-site rng: the k-th draw of a site is the same in every run
        # and does not depend on how other sites interleave with it.
        # crc32, not hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which would silently break replayability.
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = np.random.default_rng(
                zlib.crc32(f"{self.seed}/{site}".encode())
            )
        u = float(rng.random())
        if u < self._rates.get(site, 0.0):
            return "fault"
        if u < self._rates.get(site, 0.0) + self._slow_rates.get(site, 0.0):
            return "slow"
        return "pass"

    def check(self, site: str) -> None:
        """Consult the injector at ``site``; may sleep or raise.

        Raises ``InjectedFault`` on a fault verdict; sleeps
        ``slow_step_s`` on a slow verdict; otherwise returns.
        """
        with self._lock:
            counts = self._counts.setdefault(
                site, {"checks": 0, "faults": 0, "slows": 0}
            )
            counts["checks"] += 1
            ordinal = counts["checks"]
            verdict = self._verdict_locked(site)
            if verdict == "fault":
                counts["faults"] += 1
            elif verdict == "slow":
                counts["slows"] += 1
        if verdict == "slow":
            self._sleep(self.slow_step_s)
        elif verdict == "fault":
            raise InjectedFault(site, ordinal)

    @staticmethod
    def replica_site(site: str, index: int) -> str:
        """The scripted-only site name scoping ``site`` to one replica."""
        return f"{site}#{int(index)}"

    def check_replica(self, site: str, index: int) -> None:
        """``check`` for replica ``index`` of ``site``.

        A verdict scripted for the replica site (``fail_next(
        replica_site(site, i))``) OVERRIDES the base site entirely —
        including a scripted "pass", so a test can pin one replica
        healthy. With nothing scripted for the replica, the base site is
        consulted as usual (its ordinal stream is shared by all
        replicas, in dispatch order).
        """
        rep = self.replica_site(site, index)
        with self._lock:
            scripted = bool(self._scripts.get(rep))
        if scripted:
            # replica sites carry no seeded rates: an exhausted script
            # can never fault by accident, only by being scripted again
            self.check(rep)
        else:
            self.check(site)

    def snapshot(self) -> dict:
        with self._lock:
            return {site: dict(c) for site, c in self._counts.items()}

    # ----------------------------------------------------------- file faults

    @staticmethod
    def corrupt_bytes(data: bytes, seed: int = 0, n_flips: int = 16) -> bytes:
        """Flip ``n_flips`` deterministic byte positions of ``data``."""
        buf = bytearray(data)
        if not buf:
            return bytes(buf)
        rng = np.random.default_rng(seed)
        for pos in rng.integers(0, len(buf), size=n_flips):
            buf[int(pos)] ^= 0xFF
        return bytes(buf)

    @classmethod
    def corrupt_file(cls, path: str, seed: int = 0, n_flips: int = 16) -> str:
        """Deterministically flip bytes of ``path`` in place."""
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(cls.corrupt_bytes(data, seed=seed, n_flips=n_flips))
        return path

    @staticmethod
    def truncate_file(path: str, keep_fraction: float = 0.5) -> str:
        """Truncate ``path`` to ``keep_fraction`` of its size in place."""
        import os

        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(0, int(size * keep_fraction)))
        return path
