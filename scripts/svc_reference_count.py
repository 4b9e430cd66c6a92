#!/usr/bin/env python3
"""Support-vector count of the reference trainer on chip_smoke.py's mnist C-SVC.

    PYTHONPATH=src python scripts/svc_reference_count.py

Trains ``repro.svm.dual.train_svc`` (JAX, on the CPU) and the port's
``repro_torch.svm.train_svc`` (on the CPU) on the task that
``chip_smoke.py``'s third path gives its mnist C-SVC: the first
``SVC_ROWS`` rows of ``make_dataset("mnist", scale=0.1, seed=SEED)`` at
the spec gamma, C = ``SVC_C``, ``SVC_STEPS`` steps. Prints one JSON line
with both counts and each trainer's smallest kept alpha over the
threshold, and exits 1 unless both counts equal
``chip_smoke.SVC_MNIST_N_SV``, the count the card's run is gated against.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SV_THRESHOLD = 1e-6  # both trainers' default: alpha > SV_THRESHOLD * C


def main() -> int:
    import jax.numpy as jnp
    import torch

    from repro.data.synthetic import make_dataset
    from repro.svm.dual import train_svc as train_ref
    from repro_torch.svm import train_svc as train_port

    X, y, _, _, spec = make_dataset("mnist", scale=0.1, seed=chip_smoke.SEED)
    X, y = X[: chip_smoke.SVC_ROWS], y[: chip_smoke.SVC_ROWS].astype(np.float32)
    C, steps = chip_smoke.SVC_C, chip_smoke.SVC_STEPS
    ref, ref_mask = train_ref(
        jnp.asarray(X),
        jnp.asarray(y),
        jnp.float32(spec.paper_gamma),
        jnp.float32(C),
        num_steps=steps,
    )
    port, port_mask = train_port(
        torch.from_numpy(X),
        torch.from_numpy(y),
        spec.paper_gamma,
        C,
        num_steps=steps,
        device="cpu",
    )
    cut = SV_THRESHOLD * C
    ref_alpha = np.abs(np.asarray(ref.alpha_y))[np.asarray(ref_mask)] / cut
    port_alpha = port.alpha_y.abs()[port_mask].numpy() / cut
    out = dict(
        n=len(y),
        gamma=spec.paper_gamma,
        c=C,
        steps=steps,
        reference_n_sv=int(np.asarray(ref_mask).sum()),
        port_cpu_n_sv=int(port_mask.sum()),
        gated_n_sv=chip_smoke.SVC_MNIST_N_SV,
        reference_min_kept_alpha_over_threshold=float(ref_alpha.min()),
        port_min_kept_alpha_over_threshold=float(port_alpha.min()),
    )
    print(json.dumps(out))
    want = chip_smoke.SVC_MNIST_N_SV
    return 0 if out["reference_n_sv"] == out["port_cpu_n_sv"] == want else 1


if __name__ == "__main__":
    sys.exit(main())
