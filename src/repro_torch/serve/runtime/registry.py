"""``ArtifactRegistry`` — a content-addressed, multi-tenant model store.

``CompiledArtifact.save`` is byte-deterministic precisely so a store
can key on content; this module is that store. Identity is the
SHA-256 of the artifact's deterministic bytes (``CompiledArtifact
.digest()``), which means:

  * **dedupe for free** — registering the same compile twice (same model,
    same seed, any process) lands on one entry, one engine, one copy of
    the arrays in memory;
  * **lazy directory loads** — a directory of ``.npz`` artifacts is
    indexed by hashing FILE bytes (``save`` writes exactly
    ``to_bytes()``, so the file hash IS the artifact digest) without
    deserializing a single array; arrays load on first use;
  * **aliases** — mutable names (``mnist@latest``) over immutable
    digests, git-tag style. ``set_alias`` is atomic under the registry
    lock: a reader resolves either the old digest or the new one, never
    a torn state, and in-flight requests hold a reference to the OLD
    engine so a hot-swap never yanks a model mid-batch.
  * **LRU engine eviction** — built engines (compiled steps + device
    arrays) are the expensive part; under a ``memory_budget_bytes`` cap
    the registry drops the least-recently-used cold engines. An entry
    backed by a file also drops its arrays (reloadable); an in-memory
    registration keeps them (they are the only copy). Eviction never
    touches the entry's identity — the digest and aliases survive, and
    the next use transparently reloads.
  * **corruption quarantine** — content addressing makes disk integrity
    CHECKABLE, so the registry checks it: ``add_file`` structurally
    validates the ``.npz`` (zip CRC over every member + header present)
    and raises a typed ``ArtifactCorrupt`` for a flipped-bytes or
    truncated file; every load-from-path re-hashes the file and refuses
    to build an engine unless the SHA-256 still equals the registered
    digest — a file mutated on disk AFTER indexing can never serve
    under its old identity. A corrupt entry is QUARANTINED: subsequent
    resolves fail fast with the stored reason instead of re-reading a
    bad file in a retry loop. (Injected transient load faults — the
    chaos harness's ``registry_load`` site — do NOT quarantine: the
    next resolve retries, which is the point of "transient".)

Engines run where ``engine_opts["device"]`` says: on the card unless it
names the CPU (``repro_torch.device.resolve``). Registering or indexing
a model raises at once when that card is missing, so nothing is ever
built on the CPU because no card was found; files load straight onto
the engine's device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import threading
import zipfile

import torch

from repro_torch import device as _device
from repro_torch.core.families import CompiledArtifact
from repro_torch.core.families.base import _HEADER_MEMBER
from repro_torch.serve.runtime.errors import ArtifactCorrupt, ModelNotFound
from repro_torch.serve.runtime.faults import REGISTRY_LOAD, FaultInjector
from repro_torch.serve.runtime.publish import PublishSpec, resolve_spec
from repro_torch.serve.svm_engine import SVMEngine

_DIGEST_LEN = 64           # sha256 hex


@dataclasses.dataclass
class RegistryEntry:
    """One immutable model identity and its (re)loadable serving state."""

    digest: str
    path: str | None = None                 # reload source for lazy/evicted
    artifact: CompiledArtifact | None = None
    exact: object | None = None             # SVMModel for the exact fallback
    engine: SVMEngine | None = None         # primary replica (replicas[0])
    replicas: int = 1                       # engines to build from this digest
    engines: list = dataclasses.field(default_factory=list)
    warmup: bool | None = None              # per-model warmup_on_load override
    nbytes: int = 0                         # resident bytes once known
    tick: int = 0                           # LRU clock stamp
    evictions: int = 0
    quarantined: str | None = None          # corruption reason; fail fast
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def local_devices(engine_opts: dict) -> list[torch.device]:
    """The devices replicas are pinned across: every CUDA device when the
    options name none or a CUDA one, else the one they name (the CPU).
    Raises when CUDA is meant and no card is present."""
    dev = _device.resolve(engine_opts.get("device"))
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _validate_npz(path: str, digest: str) -> None:
    """Structural check of a saved artifact: a readable zip, every member
    CRC-clean, header member present. Catches truncation and byte flips
    without deserializing any array (CRC pass streams the file once).
    """
    try:
        with zipfile.ZipFile(path) as zf:
            bad = zf.testzip()
            names = set(zf.namelist())
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise ArtifactCorrupt(
            f"{path} is not a readable artifact npz: {e}",
            digest=digest, path=path,
        ) from e
    if bad is not None:
        raise ArtifactCorrupt(
            f"{path}: member {bad!r} fails CRC (corrupt bytes)",
            digest=digest, path=path,
        )
    if f"{_HEADER_MEMBER}.npy" not in names:
        raise ArtifactCorrupt(
            f"{path}: missing {_HEADER_MEMBER!r} header (truncated or not "
            f"an artifact)",
            digest=digest, path=path,
        )


class ArtifactRegistry:
    def __init__(
        self,
        *,
        memory_budget_bytes: int | None = None,
        warmup_on_load: bool = True,
        engine_opts: dict | None = None,
        fault_injector: FaultInjector | None = None,
        obs=None,
    ):
        self.memory_budget_bytes = memory_budget_bytes
        self.warmup_on_load = warmup_on_load
        self.engine_opts = dict(engine_opts or {})
        self.faults = fault_injector         # consulted at every path load
        # obs.Observability (or None): engine loads, evictions and
        # quarantines are recorded as spans under the digest prefix and
        # as model_digest-labelled counters. Runtime injects its bundle
        # here when the caller did not.
        self.obs = obs
        self._entries: dict[str, RegistryEntry] = {}
        self._aliases: dict[str, str] = {}
        self._lock = threading.RLock()
        self._clock = itertools.count(1)
        self._evict_listeners: list = []
        self.loads = 0                       # engine builds (incl. reloads)
        self.hits = 0                        # get_engine served from memory
        self.eviction_count = 0
        self.quarantine_count = 0

    def _obs_event(self, span_name: str, counter_name: str, help_text: str,
                   digest: str, attrs: dict | None = None) -> None:
        """Record one registry lifecycle event (span + counter). Must be
        called OUTSIDE the registry lock — the tracer/metric locks are
        independent, but registry events are rare enough that holding
        ``self._lock`` across them would be pure contention."""
        obs = self.obs
        if obs is None:
            return
        obs.tracer.span(digest[:12], span_name, attrs=attrs)
        obs.metrics.counter(
            counter_name, help_text, ("model_digest",)
        ).labels(model_digest=digest[:12]).inc()

    def add_evict_listener(self, fn) -> None:
        """``fn(digest)`` fires after an engine eviction, OUTSIDE the
        registry lock — the hook ``Runtime`` uses to retire the digest's
        batcher so eviction actually releases the engine's memory (an
        idle batcher would otherwise pin it forever)."""
        self._evict_listeners.append(fn)

    # -------------------------------------------------------------- indexing

    def register(
        self,
        artifact: CompiledArtifact,
        spec: PublishSpec | None = None,
        *,
        alias: str | None = None,
        exact=None,
        path: str | None = None,
        replicas: int | None = None,
    ) -> str:
        """Index ``artifact`` under its content digest; returns the digest.

        Options travel in one ``PublishSpec`` — the same shape
        ``Runtime.publish`` and the HTTP management API serialize (the
        bare ``alias``/``exact``/``path``/``replicas`` kwargs are
        deprecated-but-accepted aliases for ``spec=PublishSpec(...)``).

        Re-registering an identical compile is a no-op on the entry
        (dedupe); ``alias``/``exact``/``path`` still update, so a caller
        can attach a fallback model or a name to an existing digest.

        ``replicas=N`` asks for N engines from this one digest (content
        addressing makes them trivially consistent — same bytes, same
        compiled step), each pinned round-robin to a local device.
        ``None`` leaves the entry's current replica count alone, so a
        plain re-register never silently collapses a scaled-out model.
        """
        spec = resolve_spec(spec, caller="ArtifactRegistry.register",
                            alias=alias, exact=exact, path=path,
                            replicas=replicas)
        local_devices(self.engine_opts)     # no card for the engines: raise
        digest = artifact.digest()
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                entry = RegistryEntry(digest=digest, artifact=artifact)
                self._entries[digest] = entry
            elif entry.artifact is None:
                entry.artifact = artifact
            if spec.exact is not None:
                entry.exact = spec.exact
            if spec.path is not None:
                entry.path = spec.path
            if spec.warmup is not None:
                entry.warmup = spec.warmup
            if spec.replicas is not None:
                r = int(spec.replicas)
                if r != entry.replicas:
                    # retire every built replica atomically: the next
                    # resolve rebuilds at the new count, and the runtime's
                    # engine-identity check retires the stale batcher
                    entry.replicas = r
                    entry.engines = []
                    entry.engine = None
            if spec.alias is not None:
                self._aliases[spec.alias] = digest
        return digest

    def add_file(self, path: str, spec: PublishSpec | None = None, *,
                 alias: str | None = None, exact=None) -> str:
        """Index one saved artifact WITHOUT loading its arrays.

        ``save`` writes exactly ``to_bytes()``, so hashing the file bytes
        yields the same digest ``artifact.digest()`` would — content
        addressing straight off the filesystem.

        The file is structurally validated first (zip CRC + header): a
        corrupt or truncated artifact raises ``ArtifactCorrupt`` and is
        never indexed — a bad file must not acquire an identity.

        ``spec`` carries the publication options (alias/replicas/warmup/
        exact; its ``path`` field is ignored — the positional ``path``
        is authoritative here). The bare ``alias``/``exact`` kwargs
        remain first-class for this entry point (not deprecated): a
        file index is the one place the file IS the argument.
        """
        if spec is None:
            spec = PublishSpec(alias=alias, exact=exact)
        elif alias is not None or exact is not None:
            raise TypeError(
                "ArtifactRegistry.add_file: pass either spec= or "
                "alias=/exact=, not both"
            )
        local_devices(self.engine_opts)     # no card for the engines: raise
        digest = _hash_file(path)
        _validate_npz(path, digest)
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                entry = RegistryEntry(digest=digest, path=path)
                self._entries[digest] = entry
            elif entry.path is None:
                entry.path = path
            if spec.exact is not None:
                entry.exact = spec.exact
            if spec.warmup is not None:
                entry.warmup = spec.warmup
            if spec.replicas is not None and spec.replicas != entry.replicas:
                entry.replicas = int(spec.replicas)
                entry.engines = []
                entry.engine = None
            if spec.alias is not None:
                self._aliases[spec.alias] = digest
        return digest

    def add_directory(self, dirpath: str, *, tag: str = "latest") -> dict[str, str]:
        """Lazily index every ``*.npz`` under ``dirpath``.

        Each file gets the alias ``<stem>@<tag>`` (stems sorted, so a
        duplicated stem deterministically resolves to the lexicographically
        last file). Returns ``{alias: digest}`` for what was indexed.
        """
        added: dict[str, str] = {}
        for name in sorted(os.listdir(dirpath)):
            if not name.endswith(".npz"):
                continue
            stem = name[: -len(".npz")]
            alias = f"{stem}@{tag}"
            added[alias] = self.add_file(os.path.join(dirpath, name), alias=alias)
        return added

    # --------------------------------------------------------------- aliases

    def set_alias(self, alias: str, ref: str) -> str:
        """Atomically point ``alias`` at ``ref`` (digest or other alias).

        This is the hot-swap primitive: publish the new artifact (its
        digest is already immutable in the store), then flip the alias.
        Readers between the two states see a complete old model or a
        complete new model; requests already holding the old engine
        finish on it untouched.
        """
        with self._lock:
            digest = self.resolve(ref)
            self._aliases[alias] = digest
            return digest

    def publish(self, alias: str, artifact: CompiledArtifact,
                spec: PublishSpec | None = None, *, exact=None,
                replicas: int | None = None) -> str:
        """Register + flip ``alias`` in one atomic step; returns the digest."""
        spec = resolve_spec(spec, caller="ArtifactRegistry.publish",
                            exact=exact, replicas=replicas)
        spec = dataclasses.replace(spec, alias=alias)
        with self._lock:
            return self.register(artifact, spec)

    def aliases(self) -> dict[str, str]:
        with self._lock:
            return dict(self._aliases)

    def resolve(self, ref: str) -> str:
        """``ref`` → digest: exact digest, alias, ``ref@latest``, or a
        unique digest prefix (git-style)."""
        with self._lock:
            if len(ref) == _DIGEST_LEN and ref in self._entries:
                return ref
            if ref in self._aliases:
                return self._aliases[ref]
            tagged = f"{ref}@latest"
            if tagged in self._aliases:
                return self._aliases[tagged]
            matches = [d for d in self._entries if d.startswith(ref)]
            if len(matches) == 1:
                return matches[0]
            if len(matches) > 1:
                raise ModelNotFound(
                    f"ambiguous model ref {ref!r} ({len(matches)} matches)",
                    ref=ref,
                )
            raise ModelNotFound(
                f"unknown model ref {ref!r}; known aliases: "
                f"{sorted(self._aliases)}",
                ref=ref,
            )

    # --------------------------------------------------------------- serving

    def get_engine(self, ref: str) -> tuple[str, SVMEngine]:
        """(digest, primary ready engine) for ``ref``; builds on miss."""
        digest, engines = self.get_engines(ref)
        return digest, engines[0]

    def get_engines(self, ref: str) -> tuple[str, list[SVMEngine]]:
        """(digest, replica engines) for ``ref``; loads/builds/warms on miss.

        The build happens under the ENTRY lock, not the registry lock, so
        warming one cold model never stalls lookups of hot ones. All of
        the entry's replicas are built together (and evicted together):
        a caller never observes a half-scaled model.

        Raises ``ArtifactCorrupt`` (fail-fast, no disk retry) for a
        quarantined entry, and quarantines on the spot if the reload
        finds the file's hash no longer matches the registered digest.
        """
        with self._lock:
            digest = self.resolve(ref)
            entry = self._entries[digest]
            if entry.quarantined is not None:
                raise ArtifactCorrupt(
                    f"model {digest[:12]} is quarantined: {entry.quarantined}",
                    digest=digest, path=entry.path,
                )
            entry.tick = next(self._clock)
            engines = list(entry.engines)
            want = max(1, entry.replicas)
        if len(engines) == want:
            self.hits += 1                   # approximate under race; fine
            return digest, engines
        with entry.lock:
            with self._lock:                 # re-check under the build lock
                engines = list(entry.engines)
                want = max(1, entry.replicas)
            if len(engines) != want:
                artifact = entry.artifact
                if artifact is None:
                    if entry.path is None:
                        raise RuntimeError(
                            f"entry {digest[:12]} has no artifact and no path"
                        )
                    artifact = self._load_verified(entry)
                warm = (self.warmup_on_load if entry.warmup is None
                        else entry.warmup)
                engines = self._build_replicas(artifact, entry.exact, want,
                                               warmup=warm)
                with self._lock:
                    entry.artifact = artifact
                    # each replica bakes its own device copy of the arrays
                    entry.nbytes = artifact.nbytes() * want
                    entry.engines = engines
                    entry.engine = engines[0]
                    self.loads += 1
                self._obs_event(
                    "registry.load", "repro_registry_loads_total",
                    "Engine builds (including reloads after eviction).",
                    digest, attrs={"replicas": want,
                                   "nbytes": artifact.nbytes() * want,
                                   "warmed": warm},
                )
        self._evict_to_budget(keep=digest)
        return digest, engines

    def _build_replicas(self, artifact, exact, count: int, *,
                        warmup: bool | None = None) -> list[SVMEngine]:
        """``count`` engines off one artifact, pinned round-robin across
        local devices (pinning is skipped when the caller already chose
        placement via ``device=`` / ``head_mesh=`` engine opts)."""
        if warmup is None:
            warmup = self.warmup_on_load
        devices = local_devices(self.engine_opts)
        engines = []
        for i in range(count):
            opts = dict(self.engine_opts)
            if (count > 1 and "device" not in opts
                    and "head_mesh" not in opts):
                opts["device"] = devices[i % len(devices)]
            engine = SVMEngine(artifact, exact, **opts)
            if warmup:
                engine.warmup()
            engines.append(engine)
        return engines

    def _quarantine(self, entry: RegistryEntry, reason: str) -> None:
        with self._lock:
            if entry.quarantined is not None:
                return
            entry.quarantined = reason
            self.quarantine_count += 1
        self._obs_event(
            "registry.quarantine", "repro_registry_quarantined_total",
            "Entries quarantined for content-identity violations.",
            entry.digest, attrs={"reason": reason},
        )

    def _load_verified(self, entry: RegistryEntry) -> CompiledArtifact:
        """(Re)load ``entry.path`` with identity verification.

        Every path load — first lazy load AND reload-after-evict —
        re-hashes the file: content addressing means the digest is not
        provenance metadata but the entry's NAME, so a file whose bytes
        changed on disk simply is not this model anymore. Mismatch or an
        unparseable file quarantines the entry (fail fast on the next
        resolve, no retry loop against a bad disk).
        """
        if self.faults is not None:
            # transient injected load failure: raises InjectedFault and
            # deliberately does NOT quarantine — the next resolve retries
            self.faults.check(REGISTRY_LOAD)
        actual = _hash_file(entry.path)
        if actual != entry.digest:
            reason = (f"file hash {actual[:12]} != registered digest "
                      f"{entry.digest[:12]} (mutated on disk)")
            self._quarantine(entry, reason)
            raise ArtifactCorrupt(
                f"{entry.path}: {reason}", digest=entry.digest, path=entry.path
            )
        try:
            return CompiledArtifact.load(
                entry.path, device=self.engine_opts.get("device")
            )
        except Exception as e:
            reason = f"unparseable artifact file: {e}"
            self._quarantine(entry, reason)
            raise ArtifactCorrupt(
                f"{entry.path}: {reason}", digest=entry.digest, path=entry.path
            ) from e

    def evict(self, ref: str) -> str:
        """Administratively drop ``ref``'s built engines; returns the digest.

        Same semantics as a budget eviction: identity (digest, aliases,
        registration) survives, the next use transparently rebuilds. An
        in-memory registration keeps its artifact (it is the only copy);
        a file-backed one drops the arrays too. Evict listeners fire
        outside the lock so the runtime retires the digest's batcher.
        """
        with self._lock:
            digest = self.resolve(ref)
            entry = self._entries[digest]
            had_engine = entry.engine is not None
            entry.engine = None
            entry.engines = []
            if entry.path is not None:
                entry.artifact = None
            if had_engine:
                entry.evictions += 1
                self.eviction_count += 1
        if had_engine:
            self._obs_event(
                "registry.evict", "repro_registry_evictions_total",
                "Engines evicted under the memory budget.",
                digest, attrs={"reason": "admin"},
            )
            for fn in self._evict_listeners:
                fn(digest)
        return digest

    def set_replicas(self, ref: str, replicas: int) -> str:
        """Re-scale ``ref`` to ``replicas`` engines; returns the digest.

        Retires every built replica atomically (the next resolve rebuilds
        at the new count) and notifies evict listeners so the runtime
        swaps the digest's batcher onto the fresh engine set.
        """
        r = int(replicas)
        if r < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        with self._lock:
            digest = self.resolve(ref)
            entry = self._entries[digest]
            changed = r != entry.replicas
            if changed:
                entry.replicas = r
                entry.engines = []
                entry.engine = None
        if changed:
            for fn in self._evict_listeners:
                fn(digest)
        return digest

    def loaded_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.engine is not None)

    def _evict_to_budget(self, keep: str | None = None) -> int:
        """Drop LRU engines until loaded bytes fit the budget; returns count.

        The entry most recently touched (``keep``) is never evicted — the
        budget is a pressure valve, not a correctness gate, and evicting
        the model being served would thrash.
        """
        if self.memory_budget_bytes is None:
            return 0
        evicted: list[str] = []
        with self._lock:
            loaded = [e for e in self._entries.values() if e.engine is not None]
            total = sum(e.nbytes for e in loaded)
            for entry in sorted(loaded, key=lambda e: e.tick):
                if total <= self.memory_budget_bytes:
                    break
                if entry.digest == keep:
                    continue
                entry.engine = None          # every replica retires together:
                entry.engines = []           # eviction is all-or-nothing
                if entry.path is not None:
                    entry.artifact = None    # reloadable: drop the arrays too
                entry.evictions += 1
                total -= entry.nbytes
                evicted.append(entry.digest)
                self.eviction_count += 1
        for digest in evicted:               # listeners run outside the lock
            self._obs_event(
                "registry.evict", "repro_registry_evictions_total",
                "Engines evicted under the memory budget.",
                digest,
            )
            for fn in self._evict_listeners:
                fn(digest)
        return len(evicted)

    # ------------------------------------------------------------- telemetry

    def list_models(self) -> list[dict]:
        """One JSON-able row per registered digest — the management
        API's ``GET /v1/models`` body."""
        with self._lock:
            alias_of: dict[str, list[str]] = {}
            for a, d in self._aliases.items():
                alias_of.setdefault(d, []).append(a)
            return [
                {
                    "digest": e.digest,
                    "aliases": sorted(alias_of.get(e.digest, [])),
                    "loaded": e.engine is not None,
                    "replicas": e.replicas,
                    "path": e.path,
                    "nbytes": e.nbytes,
                    "evictions": e.evictions,
                    "quarantined": e.quarantined,
                }
                for e in self._entries.values()
            ]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "models": len(self._entries),
                "loaded": sum(
                    1 for e in self._entries.values() if e.engine is not None
                ),
                "loaded_bytes": sum(
                    e.nbytes for e in self._entries.values() if e.engine is not None
                ),
                "memory_budget_bytes": self.memory_budget_bytes,
                "loads": self.loads,
                "hits": self.hits,
                "evictions": self.eviction_count,
                "quarantined": self.quarantine_count,
                "aliases": dict(self._aliases),
            }
