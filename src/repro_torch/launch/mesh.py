"""Device meshes for scale-out serving.

``repro`` builds ``jax.sharding.Mesh`` objects and runs each shard under
``shard_map``, one program driving every local device. The port keeps
that single-controller shape: a ``Mesh`` here is a named grid of
``torch.device``s, and the sharded primitives in ``core.backend`` launch
each shard's kernel on its shard's device from the one calling thread,
then gather the results on the mesh's first device.

A device may appear more than once: ``make_mesh((4,), ("heads",),
devices=["cuda:0"] * 4)`` splits the work four ways on one card (four
launches and a gather in place of one launch), as ``repro``'s test suite
forces eight host devices onto one CPU.

``make_production_mesh`` builds the reference's production topology,
(16, 16) over ("data", "model") or (2, 16, 16) with "pod" in front, over
the devices given: every CUDA device by default, so it raises below 256
(or 512) cards; the dry run (``launch.dryrun``) passes fake ones.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import pin


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` laid out row-major over ``axis_names`` with ``sizes``.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does; the sharded serving paths read ``axis_names[0]``,
    ``shape[axis]`` and ``shard_devices()``. ``devices`` is empty on an
    abstract mesh (``sharding.partitioning.abstract_mesh``: names and
    sizes only, for the partitioning rules).
    """

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def shard_devices(self) -> tuple[torch.device, ...]:
        """The device of each position along the first axis: the first
        device of its slice (the other axes hold replicas)."""
        stride = self.size // self.sizes[0]
        return self.devices[::stride]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` named ``axes`` over ``devices`` (row-major).

    ``devices`` defaults to every CUDA device, and then raises where there
    is none; nothing falls back to the CPU. The mesh must hold exactly
    ``prod(shape)`` devices (``ValueError`` otherwise); a device may be
    named more than once.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes) or not shape:
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes must be distinct, got {axes}")
    if min(shape) < 1:
        raise ValueError(f"mesh axis sizes must be positive, got {shape}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; name the mesh's devices "
                "(devices=['cpu'] * n) to build one on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(pin(d) for d in devices)
    if len(devices) != math.prod(shape):
        raise ValueError(
            f"a {shape} mesh needs {math.prod(shape)} devices, got {len(devices)}"
        )
    return Mesh(devices=devices, axis_names=axes, sizes=shape)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) with "pod" in front, over ``devices`` (every CUDA device by
    default). Raises, as ``make_mesh`` does, without exactly 256 (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)
