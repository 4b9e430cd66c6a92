"""Asyncio bridge over the runtime's future-based ``submit``.

``Runtime.submit`` returns a ``concurrent.futures.Future[SliceResult]``
and is itself mildly blocking (registry resolve, possibly a cold engine
build, queue admission under the batcher lock). The event loop must
block on none of that, and — the part that matters for throughput —
the deferred-sync contract must survive the hop: materializing
``.values`` triggers ONE device→host transfer shared by every request
coalesced into the same flush, so that sync has to happen off-loop too,
in a thread, where sibling requests amortize it.

The bridge is therefore three awaits, each with a reason:

  1. ``submit`` runs in the loop's default executor — admission sheds
     (``RuntimeOverloaded``) surface here, before anything is queued;
  2. the returned future is ``asyncio.wrap_future``-ed — zero threads
     parked while the micro-batcher waits for its flush window (a
     parked thread per in-flight request would cap coalescing at the
     executor's worker count);
  3. materialization runs back in the executor — the shared host sync
     never stalls the loop, and N coalesced requests pay for it once.

On the card the flush's result holds device tensors until it is read:
``.values`` runs the engine's ``_finalize`` (the stream waits on the
result's event, one copy to the host, fallback rows patched through
kernel B2) on the executor thread, and hands back numpy. The loop never
synchronizes the card nor touches a CUDA tensor.
"""

from __future__ import annotations

import asyncio

import numpy as np


def _materialize(res) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(values, valid, labels) as host arrays — the one shared sync."""
    return (
        np.asarray(res.values),
        np.asarray(res.valid),
        np.asarray(res.labels),
    )


async def submit(runtime, model: str, Z, *, deadline_s: float | None = None):
    """Score ``Z`` on ``model`` without blocking the event loop.

    Returns ``(values, valid, labels)`` host arrays. Raises exactly
    what the runtime raises — ``RuntimeOverloaded`` at admission,
    ``DeadlineExceeded``/``BatcherClosed``/``ArtifactCorrupt`` out of
    the future — for the app's error mapper to translate.
    """
    loop = asyncio.get_running_loop()
    fut = await loop.run_in_executor(
        None, lambda: runtime.submit(model, Z, deadline_s=deadline_s)
    )
    res = await asyncio.wrap_future(fut)
    return await loop.run_in_executor(None, _materialize, res)
