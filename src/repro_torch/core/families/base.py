"""``CompiledArtifact`` — the compile -> serve seam.

Every approximation family compiles an exact ``SVMModel`` into one of
these: a named bag of tensors plus JSON-able metadata, the only thing the
serving stack needs. ``save``/``load`` speak the same versioned ``.npz``
as ``repro``'s artifact, written with pinned zip metadata, so the same
arrays and meta give the same bytes and the same ``digest()`` in either
package: an artifact written by ``repro`` and loaded and saved again here
keeps its digest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import zipfile

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import backend

# Readers accept anything <= their own version and reject newer files.
# v2: quantized variants (int8 weights, ``dtype`` in the meta).
ARTIFACT_FORMAT_VERSION = 2

_HEADER_MEMBER = "__artifact__"

# Bias given to validity-neutral padding heads: exp-enveloped scores are
# O(|c|+|v|+|M|), so a -1e30 bias can never win an argmax, and padding
# heads carry msq = 0, which satisfies Eq 3.11 for every row.
PAD_HEAD_BIAS = -1e30


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledArtifact:
    """One servable model: ``family`` tag, tensors, JSON-able meta.

    ``meta`` always carries ``format_version``, ``d`` (feature dim),
    ``num_heads`` (K) and ``multiclass``; families add their own keys.
    ``derived`` holds what a family derives from the stored arrays to serve
    them, once per artifact (never saved, not in the digest).
    """

    family: str
    arrays: dict[str, torch.Tensor]
    meta: dict
    derived: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @property
    def d(self) -> int:
        return int(self.meta["d"])

    @property
    def num_heads(self) -> int:
        return int(self.meta["num_heads"])

    @property
    def multiclass(self) -> bool:
        return bool(self.meta["multiclass"])

    @property
    def dtype(self) -> str:
        """Weight storage dtype: "float32" or "int8" (v1 files: float32)."""
        return self.meta.get("dtype", "float32")

    def nbytes(self) -> int:
        """In-memory size of the servable arrays (Table-3 accounting)."""
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def with_meta(self, **updates) -> "CompiledArtifact":
        """Functional meta update (arrays shared, not copied)."""
        return CompiledArtifact(self.family, self.arrays, {**self.meta, **updates})

    def to(self, device) -> "CompiledArtifact":
        """The same artifact with every array on ``device``."""
        arrays = {k: v.to(device) for k, v in self.arrays.items()}
        return CompiledArtifact(self.family, arrays, self.meta)

    def to_bytes(self) -> bytes:
        """The deterministic versioned ``.npz`` bytes ``save`` writes."""
        header = json.dumps(
            {
                "format_version": ARTIFACT_FORMAT_VERSION,
                "family": self.family,
                "meta": self.meta,
                "keys": sorted(self.arrays),
            },
            sort_keys=True,
        ).encode()
        members = {_HEADER_MEMBER: np.frombuffer(header, dtype=np.uint8)}
        for name in sorted(self.arrays):
            arr = self.arrays[name].detach().cpu().numpy()
            members[name] = np.ascontiguousarray(arr)
        out = io.BytesIO()
        with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zf:
            for name, arr in members.items():
                buf = io.BytesIO()
                np.lib.format.write_array(buf, arr, allow_pickle=False)
                _write_member(zf, name + ".npy", buf.getvalue())
        return out.getvalue()

    def digest(self) -> str:
        """SHA-256 hex digest of ``to_bytes()`` — the content address."""
        return hashlib.sha256(self.to_bytes()).hexdigest()

    def save(self, path: str) -> str:
        """Write a deterministic versioned ``.npz``; returns ``path``."""
        with open(path, "wb") as f:
            f.write(self.to_bytes())
        return path

    @classmethod
    def load(cls, path: str, device=None) -> "CompiledArtifact":
        """Read an artifact written by ``save`` (either package's), onto
        ``device`` (default CUDA; raises when no card is present)."""
        dev = _device.resolve(device)
        with np.load(path, allow_pickle=False) as z:
            if _HEADER_MEMBER not in z.files:
                raise ValueError(
                    f"{path} is not a CompiledArtifact npz "
                    f"(missing {_HEADER_MEMBER!r} member)"
                )
            header = json.loads(bytes(z[_HEADER_MEMBER]).decode())
            version = header.get("format_version")
            if not isinstance(version, int) or version > ARTIFACT_FORMAT_VERSION:
                raise ValueError(
                    f"artifact format version {version!r} is newer than this "
                    f"reader (supports <= {ARTIFACT_FORMAT_VERSION}); "
                    f"upgrade repro_torch to load {path}"
                )
            arrays = {k: torch.from_numpy(z[k]).to(dev) for k in header["keys"]}
        return cls(family=header["family"], arrays=arrays, meta=header["meta"])


def _write_member(zf: zipfile.ZipFile, name: str, payload: bytes) -> None:
    """One zip member with pinned metadata (the determinism guarantee)."""
    info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_STORED
    info.external_attr = 0o644 << 16
    zf.writestr(info, payload)


def base_meta(
    *, d: int, num_heads: int, multiclass: bool, dtype: str = "float32", **extra
) -> dict:
    """The meta keys every family must provide, plus family extras."""
    return {
        "format_version": ARTIFACT_FORMAT_VERSION,
        "d": int(d),
        "num_heads": int(num_heads),
        "multiclass": bool(multiclass),
        "dtype": str(dtype),
        **extra,
    }


def as_batch(Z, device) -> torch.Tensor:
    """A batch of rows (array or tensor) as a contiguous f32 tensor on
    ``device``."""
    if not isinstance(Z, torch.Tensor):
        Z = torch.from_numpy(np.asarray(Z, dtype=np.float32))
    return Z.to(device=device, dtype=torch.float32).contiguous()


def pad_rows(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``x`` with ``pad`` rows of ``value`` appended along its first axis."""
    fill = torch.full((pad, *x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill])


def placed(artifact: "CompiledArtifact", mesh, heads: dict, shared: dict) -> dict:
    """The operands a head-sharded scorer takes, placed on ``mesh``: each
    tensor of ``heads`` cut into the shards of the mesh's first axis
    (``backend.shard_heads``), each of ``shared`` on every shard's device
    (``backend.replicate``). Placed on the first call for a mesh, kept in
    ``artifact.derived`` and reused while the mesh and the given tensors are
    the same, so a served batch moves no slab."""
    key = ("placed", tuple(heads), tuple(shared))
    given = tuple(heads.values()) + tuple(shared.values())
    hit = artifact.derived.get(key)
    if hit is not None and hit[0] == mesh:
        if all(x is y for x, y in zip(hit[1], given)):
            return hit[2]
    out = {name: backend.shard_heads(t, mesh) for name, t in heads.items()}
    out.update({name: backend.replicate(t, mesh) for name, t in shared.items()})
    artifact.derived[key] = (mesh, given, out)
    return out


def stack_heads(svm) -> tuple[torch.Tensor, torch.Tensor, int, bool]:
    """View an ``SVMModel``'s (alpha_y, b) as a K-head stack.

    Binary models store ``alpha_y`` as (n_sv,); OvR ensembles as
    (K, n_sv) with b (K,). Every family compiles the K-stacked view.
    """
    ay = svm.alpha_y
    multiclass = ay.ndim == 2
    ay2 = ay if multiclass else ay[None, :]
    b = torch.as_tensor(svm.b, device=ay.device).reshape(ay2.shape[0])
    return ay2, b, ay2.shape[0], multiclass
