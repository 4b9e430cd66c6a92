"""SVM prediction engine — the paper's application layer (§5), on PyTorch.

Serves a ``CompiledArtifact`` of any ported family through its family's
scorer: maclaurin and poly2 through kernel B1 (f32) or B3 (int8), dense
fourier through kernel B4 (f32) or B5 (int8). Rows the artifact cannot
vouch for are re-scored exactly through kernel B2: per row outside the
Eq 3.11 envelope for the quadform families, every row of a fourier
artifact whose held-out verdict (``valid_globally``) failed. The design
follows ``repro.serve.svm_engine``:

Shape buckets
  Every batch is padded on the host to the next power-of-two bucket
  (floored at ``min_bucket``, capped at ``max_batch``; longer batches are
  chunked), so the kernels see at most log2(max_batch / min_bucket) + 1
  shapes and each bucket resolves its ``TileConfig`` once.
  ``jit_cache_size`` counts the buckets resolved (PyTorch runs eagerly:
  there is no compiled step per bucket).

Deferred synchronization
  ``submit`` returns an ``EngineResult`` holding device tensors; nothing
  waits for the card until the caller reads ``.values`` / ``.labels`` /
  ``.valid``, and then each result makes one device-to-host copy (scores,
  validity and labels travel packed in one tensor). On the card a bucket
  is staged through a ring of pinned host buffers and copied with
  ``non_blocking=True``: a copy from pageable memory would wait for
  every step queued before it (``_PinnedStaging``).

Exact fallback
  Rows marked invalid are re-scored with the exact expansion over
  all K heads at once (kernel B2, every distance shared by the heads), and
  patched into the result when it is read. ``submit_exact`` serves a
  whole batch through that path (the runtime's degraded mode).

Head-sharded serving (``head_mesh``)
  With K in the thousands the stacked (K, d, d) Hessian outgrows one
  device. A ``head_mesh`` (``repro_torch.launch.make_mesh``) splits the
  heads over its first axis through the family's ``score_sharded``: the
  artifact is padded to the axis size with argmax- and validity-neutral
  heads once at build (kept engine-internal: padding changes the digest),
  each shard's slabs are placed on its device once, every step launches
  the family's kernel once a shard and gathers the scores on the mesh's
  first device, where the batch is staged; the argmax runs over the padded
  heads and ``_finalize`` slices the score columns back to the real K.

SV-sharded exact path (``mesh``)
  A ``mesh`` splits the exact model's support vectors over its first axis
  (zero rows with alpha 0 pad them to a multiple of it): a fallback or
  ``submit_exact`` step runs kernel B2 on every shard with bias 0, sums
  the partial scores on the mesh's first device and adds the bias there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import backend, families
from repro_torch.core.families import CompiledArtifact
from repro_torch.core.families.base import pad_rows
from repro_torch.core.maclaurin import ApproxModel
from repro_torch.core.rbf import SVMModel
from repro_torch.kernels.common import TileConfig, tuning


# Profiling seam: ``repro_torch.serve.runtime.obs.profile`` installs a
# ``name -> context manager`` factory (``torch.profiler.record_function``)
# here, so every engine step is a named range in a profiler trace. The
# engine never imports ``obs``; unset, a step pays one ``None`` check.
_profile_annotation = None


def set_profile_annotation(factory) -> None:
    """Install (or clear, with None) a ``name -> context manager`` factory
    wrapped around every engine step dispatch."""
    global _profile_annotation
    _profile_annotation = factory


def _annotate(name: str):
    factory = _profile_annotation
    if factory is None:
        return contextlib.nullcontext()
    return factory(name)


STAGING_SLOTS = 4  # pinned host buffers a CUDA engine stages buckets through


def bucket_size(n: int, min_bucket: int = 32, max_batch: int = 8192) -> int:
    """Next power-of-two bucket for a batch of n rows (n <= max_batch)."""
    return tuning.bucket(n, lo=min_bucket, hi=max_batch)


@dataclasses.dataclass
class EngineStats:
    """Serving counters, safe under concurrent ``submit()`` callers."""

    batches: int = 0
    instances: int = 0
    fallback_instances: int = 0
    compiled_steps: int = 0  # buckets resolved
    padded_instances: int = 0  # wasted rows from bucket padding
    degraded_batches: int = 0  # submit_exact batches
    degraded_instances: int = 0
    bucket_hits: dict = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record_batch(self, n: int, buckets: list[tuple[int, int]]) -> None:
        """One submit(): n rows chunked into [(bucket, rows_used), ...]."""
        with self._lock:
            self.batches += 1
            self.instances += n
            for bkt, m in buckets:
                self.padded_instances += bkt - m
                self.bucket_hits[bkt] = self.bucket_hits.get(bkt, 0) + 1

    def record_fallback(self, k: int) -> None:
        with self._lock:
            self.fallback_instances += k

    def record_degraded(self, n: int) -> None:
        """One ``submit_exact`` batch of n rows (kept out of the fast-path
        counters so ``fallback_rate`` is not polluted by degraded traffic)."""
        with self._lock:
            self.degraded_batches += 1
            self.degraded_instances += n

    def record_compile(self) -> None:
        with self._lock:
            self.compiled_steps += 1

    def snapshot(self) -> dict:
        """Consistent point-in-time copy of every counter (plain dict)."""
        with self._lock:
            return {
                "batches": self.batches,
                "instances": self.instances,
                "fallback_instances": self.fallback_instances,
                "fallback_rate": self.fallback_instances / max(1, self.instances),
                "compiled_steps": self.compiled_steps,
                "padded_instances": self.padded_instances,
                "padding_overhead": self.padded_instances / max(1, self.instances),
                "degraded_batches": self.degraded_batches,
                "degraded_instances": self.degraded_instances,
                "bucket_hits": dict(self.bucket_hits),
            }

    @property
    def fallback_rate(self) -> float:
        return self.fallback_instances / max(1, self.instances)

    @property
    def padding_overhead(self) -> float:
        return self.padded_instances / max(1, self.instances)


class EngineResult:
    """Device-resident scores for one submitted batch; host sync deferred.

    ``chunks`` is a list of (packed (bucket, K + 2) tensor, rows used):
    columns [0, K) are scores, K the row validity and K + 1 the label.
    """

    def __init__(self, engine: "SVMEngine", Z: np.ndarray | None, chunks, event):
        self._engine = engine
        self._Z = Z  # original rows (fallback re-scores); None if none can happen
        self._chunks = chunks
        self._event = event  # CUDA event after the last chunk, or None
        self._done = None
        self._sync = threading.Lock()
        # fires once with the finalized (values, valid, labels): the
        # runtime's scheduler records latency and per-row validity here
        self.on_materialize = None

    def block_until_ready(self) -> "EngineResult":
        if self._event is not None:
            self._event.synchronize()
        return self

    def _materialize(self):
        with self._sync:
            if self._done is None:
                self._done = self._engine._finalize(self._Z, self._chunks, self._event)
                if self.on_materialize is not None:
                    self.on_materialize(self._done)
        return self._done

    def split(self, sizes) -> list["SliceResult"]:
        """Carve this result into per-request row spans (zero-copy views;
        the parent still materializes once)."""
        spans, start = [], 0
        for sz in sizes:
            spans.append(SliceResult(self, start, start + sz))
            start += sz
        total = sum(m for _, m in self._chunks)
        if start != total:
            raise ValueError(f"split sizes sum to {start}, result has {total} rows")
        return spans

    @property
    def values(self) -> np.ndarray:
        """(n,) decision values (binary) or (n, K) per-class scores."""
        return self._materialize()[0]

    @property
    def valid(self) -> np.ndarray:
        """(n,) bool — row satisfied the Eq 3.11 envelope (fast path used)."""
        return self._materialize()[1]

    @property
    def labels(self) -> np.ndarray:
        """(n,) labels: {-1, +1} (binary) or argmax class index (OvR)."""
        return self._materialize()[2]


class SliceResult:
    """One request's rows out of a coalesced ``EngineResult``."""

    def __init__(self, parent: EngineResult, start: int, stop: int):
        self._parent = parent
        self._start = start
        self._stop = stop

    def __len__(self) -> int:
        return self._stop - self._start

    def block_until_ready(self) -> "SliceResult":
        self._parent.block_until_ready()
        return self

    def _view(self, i):
        return self._parent._materialize()[i][self._start : self._stop]

    @property
    def values(self) -> np.ndarray:
        return self._view(0)

    @property
    def valid(self) -> np.ndarray:
        return self._view(1)

    @property
    def labels(self) -> np.ndarray:
        return self._view(2)


class _PinnedStaging:
    """The pinned host buffers a CUDA engine stages each bucket through.

    A host-to-device copy from pageable memory is synchronous: PyTorch
    drains the stream before it returns, so ``submit`` would wait for every
    step queued ahead of it. From pinned memory the copy is queued like a
    kernel (``non_blocking=True``) and ``submit`` returns at once. A buffer
    is written again only after the event recorded behind its last copy
    has passed, so a pending copy never reads the rows of a later batch;
    with ``STAGING_SLOTS`` buffers the host waits only when it runs that
    many buckets ahead of the card. A buffer grows to the largest bucket
    staged through it.
    """

    def __init__(self, device: torch.device, d: int):
        self.device = device
        self.d = d
        self._slots = [[None, None] for _ in range(STAGING_SLOTS)]  # buffer, event
        self._next = 0
        self._lock = threading.Lock()  # the slot stays ours until its copy is queued

    def put(self, rows: np.ndarray, bucket: int) -> torch.Tensor:
        """``rows`` zero-padded to ``bucket`` rows, on the device."""
        m = rows.shape[0]
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % STAGING_SLOTS
            buf, event = slot
            if event is not None:
                event.synchronize()  # its last copy has read the buffer
            if buf is None or buf.shape[0] < bucket:
                buf = slot[0] = torch.empty(
                    (bucket, self.d), dtype=torch.float32, pin_memory=True
                )
            host = buf[:bucket].numpy()
            host[:m] = rows
            host[m:] = 0.0  # host-side pad
            out = buf[:bucket].to(self.device, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(torch.cuda.current_stream(self.device))
        return out


def _staging_device(device, *meshes) -> torch.device:
    """The device an engine stages batches on: the first device of the
    meshes given (they must agree), which ``device`` may only repeat, or
    ``device`` (the card unless the CPU is named) without a mesh."""
    firsts = {m.devices[0] for m in meshes if m is not None}
    if len(firsts) > 1:
        raise ValueError(f"mesh and head_mesh start on different devices: {firsts}")
    if not firsts:
        return _device.resolve(device)
    first = _device.resolve(firsts.pop())
    if device is not None and _device.pin(_device.resolve(device)) != first:
        raise ValueError(
            f"device={device} disagrees with the mesh, whose first device "
            f"{first} stages every batch"
        )
    return first


class SVMEngine:
    """Serve ``model`` (a ``CompiledArtifact``, or an ``ApproxModel`` taken
    as a maclaurin artifact) on ``device`` (the card unless the CPU is
    named).

    ``exact`` enables the per-row fallback and ``submit_exact``;
    ``allow_fallback=False`` keeps the exact model for ``submit_exact``
    (the runtime's degraded mode) but returns rows outside the envelope
    unpatched, with ``valid`` False. ``tile_config`` pins every bucket's
    ``TileConfig`` (its ``block_n`` clamped to the bucket) instead of the
    tuning table's. The reference's ``block_m`` has no counterpart: B2's
    SV tile is fixed in ``csrc/rbf_pred.cu``.

    ``head_mesh`` splits the heads, ``mesh`` the exact model's support
    vectors, over the first axis of a ``repro_torch.launch.Mesh``. Batches
    are staged on the first device of the meshes given (``device`` may
    name only that device, else ``ValueError``).
    """

    def __init__(
        self,
        model: CompiledArtifact | ApproxModel,
        exact: SVMModel | None = None,
        *,
        allow_fallback: bool = True,
        mesh=None,
        head_mesh=None,
        device=None,
        min_bucket: int = 32,
        max_batch: int = 8192,
        tile_config: TileConfig | None = None,
    ):
        if min_bucket & (min_bucket - 1) or max_batch & (max_batch - 1):
            raise ValueError("min_bucket and max_batch must be powers of two")
        self.mesh = mesh
        self.head_mesh = head_mesh
        self.device = _staging_device(device, mesh, head_mesh)
        if isinstance(model, CompiledArtifact):
            self.approx = None
            artifact = model
        elif isinstance(model, ApproxModel):
            self.approx = model
            artifact = families.maclaurin.from_approx(model)
        else:
            raise TypeError(
                f"SVMEngine serves a CompiledArtifact (or an ApproxModel), "
                f"got {type(model).__name__}"
            )
        # Under a head_mesh the slabs go to the shards' devices from where
        # they are, never whole onto one device.
        self.artifact = artifact if head_mesh is not None else artifact.to(self.device)
        self._family = families.get_family(self.artifact.family)
        self.family = self.artifact.family
        self.dtype = self.artifact.dtype
        self.exact = exact
        self.allow_fallback = allow_fallback and exact is not None
        self.tile_config = tile_config
        self.multiclass = self.artifact.multiclass
        self.num_heads = self.artifact.num_heads
        self.d = self.artifact.d
        self.min_bucket = min_bucket
        self.max_batch = max_batch
        self.bucket_configs: dict[int, TileConfig] = {}
        self.stats = EngineStats()
        self._config_lock = threading.Lock()  # guards bucket_configs
        self._staging = (
            _PinnedStaging(self.device, self.d) if self.device.type == "cuda" else None
        )

        if head_mesh is not None:
            pad = getattr(self._family, "pad_heads", None)
            sharded = getattr(self._family, "score_sharded", None)
            if pad is None or sharded is None:
                raise NotImplementedError(
                    f"family {self.family!r} has no head-sharded serving path"
                )
            shards = head_mesh.shape[head_mesh.axis_names[0]]
            self._serve_artifact = pad(self.artifact, shards)
            self._family.place_shards(self._serve_artifact, head_mesh)
        else:
            self._serve_artifact = self.artifact

        if exact is not None:
            self._build_slow(exact)

    def _build_slow(self, exact: SVMModel) -> None:
        """Place the exact model for B2: whole on the engine's device, or
        under a ``mesh`` its SVs (zero-padded to a multiple of the axis
        size, alpha 0 contributing exactly 0) in equal chunks on the
        shards' devices."""
        ay = exact.alpha_y.to(torch.float32)
        ay2 = ay[None, :] if ay.ndim == 1 else ay
        X = exact.X.to(torch.float32)
        k = ay2.shape[0]
        b = torch.as_tensor(exact.b, dtype=torch.float32).reshape(-1)
        self._bias = b.to(self.device).expand(k).contiguous()
        gamma = torch.as_tensor(exact.gamma, dtype=torch.float32).reshape(1)
        if self.mesh is None:
            devices = (self.device,)
        else:
            devices = self.mesh.shard_devices()
            pad = (-X.shape[0]) % len(devices)
            X = pad_rows(X, pad)
            ay2 = pad_rows(ay2.T, pad).T
        per = X.shape[0] // len(devices)
        self._sv_rows = per
        self._X = tuple(
            X[i * per : (i + 1) * per].to(dev).contiguous()
            for i, dev in enumerate(devices)
        )
        self._ay2 = tuple(
            ay2[:, i * per : (i + 1) * per].to(dev).contiguous()
            for i, dev in enumerate(devices)
        )
        self._gamma = tuple(gamma.to(dev) for dev in devices)
        self._zero_bias = tuple(torch.zeros(k, device=dev) for dev in devices)

    # ---------------------------------------------------------- tile tuning

    def _resolve_tile_config(self, bucket: int) -> TileConfig:
        """The TileConfig this shape bucket runs with (resolved once): the
        pinned ``tile_config`` or the tuning table's entry for the family's
        kernel and this bucket, ``block_n`` clamped to the bucket."""
        with self._config_lock:
            cached = self.bucket_configs.get(bucket)
            if cached is not None:
                return cached
            if self.tile_config is not None:
                base = self.tile_config
            else:
                kernel, key = self._family.tile_lookup(self.artifact, bucket)
                base = tuning.lookup(kernel, key)
            cfg = base.clamp_block_n(bucket)
            self.bucket_configs[bucket] = cfg
            self.stats.record_compile()
            return cfg

    # ------------------------------------------------------------- fast path

    def _pack(self, scores, valid_row):
        if self.multiclass:
            labels = scores.argmax(-1)
        else:
            labels = torch.where(scores[:, 0] >= 0, 1, -1)
        extra = torch.stack([valid_row.to(scores.dtype), labels.to(scores.dtype)], 1)
        return torch.cat([scores, extra], 1)

    def _step(self, Zp: torch.Tensor) -> torch.Tensor:
        cfg = self._resolve_tile_config(Zp.shape[0])
        art = self._serve_artifact
        if self.head_mesh is None:
            scores, valid_row = self._family.score(art, Zp, config=cfg)
        else:
            scores, valid_row = self._family.score_sharded(
                art, Zp, mesh=self.head_mesh, config=cfg
            )
        return self._pack(scores, valid_row)

    def _slow(self, Zb: torch.Tensor) -> torch.Tensor:
        """Exact (m, K) scores through kernel B2, all heads at once (under
        a ``mesh``, once a shard with bias 0, the partial sums added on the
        first device before the bias)."""
        cfg = tuning.lookup(
            "rbf_pred",
            tuning.shape_key(d=self.d, m=self._sv_rows, n=tuning.bucket(Zb.shape[0])),
        )
        if self.mesh is None:
            return backend.rbf_scores(
                Zb, self._X[0], self._ay2[0], self._gamma[0], self._bias, config=cfg
            )
        parts = zip(backend.replicate(Zb, self.mesh), self._X, self._ay2)
        total = None
        for s, (z, X, A) in enumerate(parts):
            part = backend.rbf_scores(
                z, X, A, self._gamma[s], self._zero_bias[s], config=cfg
            ).to(Zb.device)
            total = part if total is None else total + part
        return total + self._bias

    def _slow_step(self, Zp: torch.Tensor) -> torch.Tensor:
        scores = self._slow(Zp)
        return self._pack(scores, torch.zeros(Zp.shape[0], device=Zp.device))

    def _run(self, Z, step, name: str) -> tuple[np.ndarray, list, object]:
        Z = np.asarray(Z, dtype=np.float32)
        if Z.ndim != 2 or Z.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) batch, got {Z.shape}")
        chunks = []
        for start in range(0, max(Z.shape[0], 1), self.max_batch):
            rows = Z[start : start + self.max_batch]
            m = rows.shape[0]
            bkt = bucket_size(m, self.min_bucket, self.max_batch)
            with _annotate(f"{name}/b{bkt}"):
                if self._staging is not None:
                    Zp = self._staging.put(rows, bkt)
                else:
                    buf = np.zeros((bkt, self.d), dtype=np.float32)
                    buf[:m] = rows  # host-side pad
                    Zp = torch.from_numpy(buf).to(self.device)
                chunks.append((step(Zp), m))
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return Z, chunks, event

    def submit(self, Z) -> EngineResult:
        """Enqueue one batch; returns without waiting for the card."""
        Z, chunks, event = self._run(Z, self._step, f"svm_engine.step/{self.family}")
        self.stats.record_batch(Z.shape[0], [(p.shape[0], m) for p, m in chunks])
        return EngineResult(self, Z if self.allow_fallback else None, chunks, event)

    @property
    def exact_available(self) -> bool:
        """True when an exact model was given (``submit_exact`` works)."""
        return self.exact is not None

    def submit_exact(self, Z) -> EngineResult:
        """Score ``Z`` entirely through the exact path (kernel B2).

        Same deferred ``EngineResult`` as ``submit``, with every row's
        ``valid`` False: the rows were exact-served, not approximated.
        """
        if self.exact is None:
            raise RuntimeError("submit_exact needs an exact model (none given)")
        Z, chunks, event = self._run(Z, self._slow_step, "svm_engine.step_exact")
        self.stats.record_degraded(Z.shape[0])
        return EngineResult(self, None, chunks, event)

    def predict(self, Z) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous: (decision values, used_fast_path bool mask)."""
        r = self.submit(Z)
        return r.values, r.valid

    def predict_labels(self, Z) -> np.ndarray:
        """{-1, +1} (binary) or class indices (multiclass)."""
        return self.submit(Z).labels

    def bucket_for(self, n: int) -> int:
        """The padded bucket a batch of ``n`` rows dispatches into."""
        return bucket_size(max(int(n), 1), self.min_bucket, self.max_batch)

    def jit_cache_size(self) -> int:
        """Buckets resolved; bounded by log2(max_batch / min_bucket) + 1."""
        with self._config_lock:
            return len(self.bucket_configs)

    def warmup(self, batch_sizes=None) -> int:
        """Run every bucket a stream can hit once, and the exact path once
        when there is one (loading the artifact's kernel and B2 on the
        card), without counting the traffic in the serving stats."""
        if batch_sizes is None:
            batch_sizes, b = [], self.min_bucket
            while b <= self.max_batch:
                batch_sizes.append(b)
                b *= 2
        saved = self.stats
        self.stats = EngineStats(bucket_hits=dict(saved.bucket_hits))
        try:
            for n in batch_sizes:
                self.submit(np.zeros((n, self.d), np.float32)).block_until_ready()
            if self.exact is not None:
                self._slow(torch.zeros((1, self.d), device=self.device))
        finally:
            saved.bucket_hits = self.stats.bucket_hits
            saved.compiled_steps += self.stats.compiled_steps
            self.stats = saved
        return self.jit_cache_size()

    # ----------------------------------------------------------- materialize

    def _finalize(self, Z: np.ndarray | None, chunks, event=None):
        """One device-to-host copy per result: concat chunks, slice the
        padding, patch bound-violating rows through the exact path. The
        reading thread's stream first waits on the result's ``event``, so
        a result is never read ahead of the stream that wrote it."""
        k = self.num_heads
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        packed = torch.cat([p[:m] for p, m in chunks]).cpu().numpy()
        # head-sharded serving scores the padded heads; they never win the
        # argmax, so only the score columns are sliced back to the real K
        served = packed.shape[1] - 2
        scores = np.ascontiguousarray(packed[:, :k])
        valid = packed[:, served] > 0.5
        labels = packed[:, served + 1].astype(np.int32)

        if Z is not None and self.allow_fallback and not valid.all():
            idx = np.nonzero(~valid)[0]
            self.stats.record_fallback(len(idx))
            rows = torch.from_numpy(np.ascontiguousarray(Z[idx])).to(self.device)
            exact_scores = self._slow(rows).cpu().numpy()  # (m, K)
            scores[idx] = exact_scores
            if self.multiclass:
                labels[idx] = exact_scores.argmax(axis=-1)
            else:
                labels[idx] = np.where(exact_scores[:, 0] >= 0, 1, -1)

        values = scores if self.multiclass else scores[:, 0]
        return values, valid, labels
