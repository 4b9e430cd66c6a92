"""Opt-in profiling hooks around the engine/backend seam.

Two annotation layers, both off by default (zero steady-state cost —
the hot path sees one module-global ``None`` check):

* **Engine steps** — ``enable()`` installs ``torch.profiler.
  record_function`` into ``repro_torch.serve.svm_engine`` (via
  ``set_profile_annotation``), so every bucket dispatch runs inside a
  named range: ``svm_engine.step/{family}/b{bucket}`` on the fast path,
  ``svm_engine.step_exact/b{bucket}`` on the exact one.
* **Dispatch seams** — the same factory goes into
  ``repro_torch.core.backend`` (via ``backend.set_profile_scope``, a
  callback hook so the core layer never imports serving code), wrapping
  ``family_scores`` in ``repro.backend/family_scores/{family}`` and the
  exact fallback in ``repro.backend/rbf_scores``.

PyTorch runs eagerly, so a range covers exactly the host work done
inside it: the staging of the bucket, the kernel launches and the
host-side padding and packing. With CUDA activity on, each launched
kernel also appears on the card's timeline under its CUDA symbol
(``quadform_tf32...`` for B1).

``capture(path)`` bundles the whole flow: enable the hooks, run a
``torch.profiler.profile`` session with CPU activity (and CUDA activity
where a card is present), write its Chrome trace to the file ``path``
(``export_chrome_trace``; open it in ``chrome://tracing`` or Perfetto),
and restore the previous state on exit. ``Runtime.profile(model, Z,
path)`` uses it to capture exactly one coalesced step.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.core import backend as _backend

_lock = threading.Lock()
_enabled = False


def enabled() -> bool:
    """True when profiling annotations are active."""
    return _enabled


def enable(on: bool = True) -> bool:
    """Toggle profiling annotations; returns the previous state.

    Enabling installs ``torch.profiler.record_function`` into the engine
    and backend seams; disabling uninstalls it.
    """
    global _enabled
    with _lock:
        prev = _enabled
        _enabled = bool(on)
        from repro_torch.serve import svm_engine as _engine

        if _enabled:
            from torch.profiler import record_function

            _backend.set_profile_scope(record_function)
            _engine.set_profile_annotation(record_function)
        else:
            _backend.set_profile_scope(None)
            _engine.set_profile_annotation(None)
    return prev


def annotate(name: str):
    """Context manager: ``torch.profiler.record_function`` when enabled,
    a no-op otherwise. Safe to use on every hot-path step."""
    if not _enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def capture(path):
    """Profile everything inside the block into the Chrome trace ``path``.

    Enables the hooks, records a ``torch.profiler`` session (CPU, and
    CUDA when a card is present), writes it with ``export_chrome_trace``,
    then restores the previous annotation state. Once a process has run
    a session, its later kernel launches are slower: keep captures out of
    timing runs.
    """
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # the engine steps run on the batchers' flush threads, which were
    # started before the session: trace every thread, not just this one
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    prev = enable(True)
    try:
        with profile(activities=activities, experimental_config=every_thread) as prof:
            yield
        prof.export_chrome_trace(str(path))
    finally:
        enable(prev)
