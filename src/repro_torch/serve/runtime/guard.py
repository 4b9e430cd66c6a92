"""``DriftGuard`` — the drift-triggered recompile / canary / flip loop.

The compile-time accuracy contract (``compile_model`` picking the
cheapest family within a ``Budget``, the per-row §4 validity check at
serve time) is measured against the SAMPLE the model was compiled on.
Traffic drifts: if inputs grow (‖z‖² past the Maclaurin validity bound)
or shift into a regime the chosen family approximates poorly, the
runtime doesn't get WRONG — the validity check routes the offending rows
through the exact fallback — it gets SLOW, and stays slow forever. The
guard closes that loop:

  1. **watch** — the model's telemetry keeps a bounded window of recent
     per-row validity (fast-path flushes only); the guard trips when the
     WINDOWED fallback rate crosses ``threshold`` with at least
     ``min_rows`` of evidence. The windowed rate matters: a week-old
     model's lifetime rate dilutes a sudden shift into invisibility.
  2. **sample** — a seeded reservoir (Vitter's Algorithm R over rows)
     fed by the runtime's traffic-listener hook holds a uniform sample
     of RECENT traffic — the distribution the recompile should target,
     not the one the original compile assumed.
  3. **recompile** — ``compile_model(exact, budget, sample=reservoir)``
     re-runs the whole family × dtype search against current traffic;
     drift that pushed the old family out of its sweet spot simply
     makes a different candidate win.
  4. **canary** — the candidate is registered (content-addressed, NOT
     aliased) and the reservoir is scored through the real serving path
     on the candidate digest; labels are judged against the exact RBF
     expansion. Agreement below ``min_agreement`` rejects the candidate
     — the alias never flips to a model that would misserve the very
     traffic that triggered the heal.
  5. **flip** — ``set_alias`` atomically points the alias at the
     candidate. In-flight requests on the old digest drain on the old
     engine (registry hot-swap semantics); zero requests are dropped by
     a flip, which is asserted in the end-to-end drift test.

Everything is observable: ``record_recompile`` / ``record_canary`` land
in the watched model's telemetry, and ``check()`` returns a verdict dict
a test (or an ops loop) can assert on. The guard never acts on degraded
(breaker-open) traffic — those rows bypass the validity window by
construction, because an engine FAULT is not input DRIFT and recompiling
cannot fix it.

Threading: ``offer``/``check`` are safe to call from any thread;
``check`` serializes heals under an internal lock (one recompile at a
time) and enforces ``cooldown_s`` between heal attempts so a window that
stays red during a slow compile cannot stampede the compiler.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.families import compile_model
from repro_torch.core.families.base import stack_heads
from repro_torch.core.rbf import rbf_kernel
from repro_torch.serve.runtime.publish import PublishSpec


class ReservoirSampler:
    """Uniform row sample over an unbounded stream (Algorithm R), seeded.

    ``offer`` cost is O(rows accepted); memory is ``capacity`` rows.
    Thread-safe: the runtime's traffic listener calls ``offer`` from
    every client thread.
    """

    def __init__(self, capacity: int = 512, seed: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._rows: list[np.ndarray] = []
        self._seen = 0
        self._lock = threading.Lock()

    def offer(self, Z) -> None:
        Z = np.atleast_2d(np.asarray(Z, dtype=np.float32))
        with self._lock:
            for row in Z:
                self._seen += 1
                if len(self._rows) < self.capacity:
                    self._rows.append(row.copy())
                else:
                    j = int(self._rng.integers(0, self._seen))
                    if j < self.capacity:
                        self._rows[j] = row.copy()

    def sample(self) -> np.ndarray:
        with self._lock:
            if not self._rows:
                return np.zeros((0, 0), np.float32)
            return np.stack(self._rows)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def seen(self) -> int:
        with self._lock:
            return self._seen


def _exact_labels(exact, Z: np.ndarray) -> np.ndarray:
    """Ground-truth labels from the exact RBF expansion (the canary judge):
    the plain ``rbf_kernel`` on the exact model's device, in float64, so no
    TF32 product reaches it whatever the process's matmul settings (a
    judge, not a served path: no kernel)."""
    ay2, b, _, multiclass = stack_heads(exact)
    Zt = torch.from_numpy(np.asarray(Z, dtype=np.float64)).to(exact.X.device)
    K = rbf_kernel(Zt, exact.X.double(), float(exact.gamma))    # (n, n_sv)
    scores = (K @ ay2.double().T + b.double()).cpu().numpy()    # (n, K)
    if multiclass:
        return np.argmax(scores, axis=1)
    return np.where(scores[:, 0] >= 0, 1, -1)


class DriftGuard:
    """Self-healing loop for one served alias.

    Args:
      runtime:        the ``Runtime`` serving the alias.
      alias:          the mutable name to watch (and atomically re-point).
      exact:          the exact ``SVMModel`` — recompile source AND
                      canary judge. (The registry entry's ``exact`` is
                      not reused on purpose: the guard must be able to
                      heal a model published without a fallback.)
      budget:         ``Budget`` handed to ``compile_model`` on heal.
      threshold:      windowed fallback rate that arms a heal (0..1).
      min_rows:       evidence floor — no heal off a near-empty window.
      min_agreement:  canary label-agreement floor for the alias flip.
      capacity/seed:  reservoir size and determinism seed.
      cooldown_s:     wall-clock spacing between heal ATTEMPTS (pass or
                      fail), so a red window can't stampede the compiler.
      min_valid_fraction: §4 validity floor injected into the heal's
                      budget when the caller's budget leaves ``min_valid``
                      unset. The heal's entire POINT is cutting the
                      fallback rate, so a candidate that error-fits the
                      drifted sample but flags it invalid row-by-row
                      (fallback-served: correct, never fast) must lose
                      the search to one whose envelope fits the traffic.
      compile_opts:   extra kwargs for ``compile_model`` (families=...,
                      dtypes=..., family_opts=...).
      clock:          monotonic time source for cooldown spacing AND the
                      heal-history trigger timestamps surfaced through
                      ``Runtime.stats()`` — injectable so tests drive it.

    Every heal attempt lands in the watched model's telemetry
    (``record_heal`` → the ``heals`` block of ``Runtime.stats()``) and,
    when the runtime has observability enabled, as a linked span arc
    under the OLD digest's trace ring: trigger → reservoir → recompile
    → canary → flip, all sharing one heal trace id with the trigger
    span as parent.
    """

    def __init__(
        self,
        runtime,
        alias: str,
        *,
        exact,
        budget,
        threshold: float = 0.25,
        min_rows: int = 64,
        min_agreement: float = 0.98,
        capacity: int = 512,
        seed: int = 0,
        cooldown_s: float = 0.0,
        min_valid_fraction: float | None = 0.9,
        compile_opts: dict | None = None,
        clock=time.monotonic,
    ):
        self.runtime = runtime
        self.alias = alias
        self.exact = exact
        self.budget = budget
        self.threshold = float(threshold)
        self.min_rows = int(min_rows)
        self.min_agreement = float(min_agreement)
        self.cooldown_s = float(cooldown_s)
        self.min_valid_fraction = min_valid_fraction
        self.compile_opts = dict(compile_opts or {})
        self.compile_opts.setdefault("seed", seed)
        self._clock = clock
        self.reservoir = ReservoirSampler(capacity=capacity, seed=seed)
        self._heal_lock = threading.Lock()
        self._last_heal_at: float | None = None
        self._attached = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.heals: list[dict] = []            # verdict history, newest last

    # ------------------------------------------------------------- watching

    def attach(self) -> "DriftGuard":
        """Subscribe the reservoir to the alias's traffic. Idempotent."""
        if not self._attached:
            self.runtime.add_traffic_listener(self._on_traffic)
            self._attached = True
        return self

    def _on_traffic(self, model: str, digest: str, Z) -> None:
        # only the watched alias feeds the reservoir; canary submits go
        # by candidate DIGEST and are deliberately excluded (the guard
        # must not judge candidates on its own probe traffic)
        if model == self.alias:
            self.reservoir.offer(Z)

    def fallback_rate(self) -> dict:
        """The windowed drift signal for the alias's CURRENT digest."""
        return self.runtime.telemetry(self.alias).fallback_window()

    # -------------------------------------------------------------- healing

    def check(self) -> dict:
        """One watch cycle: inspect the window, heal if it's red.

        Returns a verdict dict: ``triggered`` (window crossed the
        threshold), and when triggered the full heal verdict
        (``healed``, ``agreement``, ``old_digest``, ``new_digest``,
        ``family``...). Cheap when the window is green — safe to call
        on every request or from a tight ops loop.
        """
        window = self.fallback_rate()
        verdict = {"triggered": False, "healed": False, "window": window}
        if window["rows"] < self.min_rows or window["rate"] < self.threshold:
            return verdict
        if len(self.reservoir) < self.min_rows:
            # red window but no sample to recompile against yet
            verdict.update(triggered=True, reason="reservoir too small")
            return verdict
        if not self._heal_lock.acquire(blocking=False):
            verdict.update(triggered=True, reason="heal already in progress")
            return verdict
        try:
            now = self._clock()
            if (self._last_heal_at is not None
                    and now - self._last_heal_at < self.cooldown_s):
                verdict.update(triggered=True, reason="cooldown")
                return verdict
            self._last_heal_at = now
            verdict.update(triggered=True)
            verdict.update(self._heal_locked(trigger_at=now, window=window))
            self.heals.append(verdict)
            return verdict
        finally:
            self._heal_lock.release()

    def _tracer(self):
        obs = getattr(self.runtime, "obs", None)
        return obs.tracer if obs is not None else None

    def _heal_locked(self, *, trigger_at: float, window: dict) -> dict:
        rt = self.runtime
        old_digest = rt.registry.resolve(self.alias)
        telemetry = rt.telemetry(self.alias)
        telemetry.record_recompile()
        sample = self.reservoir.sample()

        # heal arc spans: one trace, the trigger span as common parent,
        # recorded under the OLD digest's ring (where the drift happened)
        tr = self._tracer()
        model_key = old_digest[:12]
        heal_trace = trigger_id = None
        if tr is not None:
            heal_trace = tr.new_trace()
            trigger_id = tr.span(model_key, "heal.trigger",
                                 trace_id=heal_trace, attrs={
                                     "alias": self.alias,
                                     "rate": window["rate"],
                                     "rows": window["rows"],
                                 })
            tr.span(model_key, "heal.reservoir", trace_id=heal_trace,
                    parent_id=trigger_id, attrs={
                        "rows": int(sample.shape[0]),
                        "seen": self.reservoir.seen,
                    })

        def _arc(name, **attrs):
            if tr is not None:
                tr.span(model_key, name, trace_id=heal_trace,
                        parent_id=trigger_id, attrs=attrs)

        def _finish(out):
            healed = out.get("healed", False)
            entry = dict(
                trigger_at=trigger_at,
                healed=healed,
                old_digest=old_digest,
                new_digest=out.get("new_digest", ""),
                detail={k: out[k] for k in ("reason", "agreement", "family")
                        if k in out},
            )
            telemetry.record_heal(**entry)
            if healed:
                # the alias now resolves to the NEW digest; mirror the
                # flip there so ``stats(alias)`` keeps the heal visible
                rt.telemetry(out["new_digest"]).record_heal(
                    mirror=True, **entry
                )
            return out

        # 1. recompile the family × dtype search against CURRENT traffic;
        # the budget gains a validity floor (unless the caller pinned one)
        # because a heal that still fallback-serves the traffic heals nothing
        budget = self.budget
        if budget.min_valid is None and self.min_valid_fraction is not None:
            budget = dataclasses.replace(budget, min_valid=self.min_valid_fraction)
        try:
            artifact = compile_model(
                self.exact, budget, sample=sample, **self.compile_opts
            )
        except Exception as e:                  # no candidate met the budget
            telemetry.record_canary(False)
            _arc("heal.recompile", ok=False, error=str(e))
            return _finish({"healed": False, "old_digest": old_digest,
                            "reason": f"recompile failed: {e}"})
        _arc("heal.recompile", ok=True, family=artifact.family,
             dtype=artifact.dtype)

        # 2. register content-addressed (NOT aliased — candidates are
        # invisible to alias traffic until the canary passes)
        new_digest = rt.register(artifact, PublishSpec(exact=self.exact))
        if new_digest == old_digest:
            telemetry.record_canary(False)
            _arc("heal.canary", passed=False,
                 reason="recompile reproduced the serving artifact")
            return _finish({"healed": False, "old_digest": old_digest,
                            "new_digest": new_digest,
                            "reason": "recompile reproduced the serving "
                                      "artifact"})

        # 3. canary through the REAL serving path on the candidate digest
        judge = _exact_labels(self.exact, sample)
        got = np.asarray(rt.submit(new_digest, sample).result().labels)
        agreement = float(np.mean(got == judge)) if judge.size else 0.0
        passed = agreement >= self.min_agreement
        telemetry.record_canary(passed)
        _arc("heal.canary", passed=passed, agreement=agreement,
             rows=int(judge.size), candidate=new_digest[:12])
        out = {
            "healed": passed,
            "old_digest": old_digest,
            "new_digest": new_digest,
            "family": artifact.family,
            "dtype": artifact.dtype,
            "agreement": agreement,
            "canary_rows": int(judge.size),
        }
        if not passed:
            out["reason"] = (f"canary agreement {agreement:.4f} < "
                             f"{self.min_agreement}")
            return _finish(out)

        # 4. atomic flip; old-digest traffic in flight drains untouched
        rt.set_alias(self.alias, new_digest)
        telemetry.reset_fallback_window()       # old window is stale evidence
        _arc("heal.flip", old_digest=old_digest[:12],
             new_digest=new_digest[:12], alias=self.alias)
        return _finish(out)

    # ------------------------------------------------------- background loop

    def start(self, interval_s: float = 1.0) -> "DriftGuard":
        """Run ``check()`` every ``interval_s`` on a daemon thread."""
        self.attach()
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.check()
                except Exception:               # the watchdog must not die
                    pass

        self._thread = threading.Thread(
            target=_loop, name=f"driftguard-{self.alias}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
