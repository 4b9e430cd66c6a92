"""SHA-256 of kernel B1's outputs at ``chip_smoke.py``'s n=1024 inputs, so
that two trees' builds can be compared bit for bit on one card without a
stored digest (which would pin one compiler).

    python3 scripts/quadform_b1_digest.py make build/b1_inputs.pt
    python3 scripts/quadform_b1_digest.py run build/b1_inputs.pt [TREE]

``make`` builds the inputs as ``chip_smoke.py``'s first path does (its
random n_sv=16384 model at the mnist width compiled to a maclaurin artifact
on the card, and 1024 test rows with every 37th pushed just out of the
envelope) and saves them. ``run`` launches ``quadform_heads_cuda`` of the
tree at TREE (default: this checkout; its ``src`` goes first on the import
path and its kernels build under TREE/build) on them with its default
tiles, and prints one JSON line: the card, the tree and the SHA-256 of the
scores, |z|^2 and the mask. Run it from two trees on one card in one call.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def make(path: str) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import convert
    from repro_torch.core import families
    from repro_torch.data.synthetic import make_dataset

    dev = torch.device("cuda")
    X_tr, _, X_te, _, spec = make_dataset("mnist", scale=0.3, seed=cs.SEED)
    rng = np.random.default_rng(cs.SEED)
    X = X_tr[: cs.N_SV]
    alpha_y = rng.standard_normal((cs.K, cs.N_SV))
    alpha_y = (alpha_y - alpha_y.mean(1, keepdims=True)).astype(np.float32)
    gamma = np.float32(spec.paper_gamma)
    sv_sq = (X.astype(np.float64) ** 2).sum(1)
    b = -(alpha_y.astype(np.float64) @ np.exp(-float(gamma) * sv_sq))
    b = b.astype(np.float32)
    svm = convert.svm_from_numpy(X, alpha_y, b, gamma, device=dev)
    a = families.maclaurin.compile(svm).arrays
    Z = X_te[:1024].copy()
    Z[::37] = cs.push_out(Z[::37], float(a["msq"].max()), float(gamma))
    heads = {k: a[k].cpu() for k in ("M", "v", "c", "b", "gamma", "msq")}
    torch.save({"Z": torch.from_numpy(Z), **heads}, path)
    print(json.dumps({"saved": path, "n": len(Z), "d": spec.d}), flush=True)


def run(path: str, tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch

    from repro_torch.kernels.quadform import kernel as qf

    dev = torch.device("cuda")
    x = {k: v.to(dev) for k, v in torch.load(path).items()}
    heads = [x[k] for k in ("M", "v", "c", "b", "gamma", "msq")]
    out = qf.quadform_heads_cuda(x["Z"], *heads)
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    line = {"card": card, "tree": tree, "source": qf.__file__}
    for name, t in zip(("scores", "zsq", "valid"), out):
        line[f"sha256_{name}"] = hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["make"] and len(sys.argv) == 3:
        make(sys.argv[2])
    elif sys.argv[1:2] == ["run"] and len(sys.argv) in (3, 4):
        run(sys.argv[2], sys.argv[3] if len(sys.argv) == 4 else str(ROOT))
    else:
        sys.exit(__doc__)
