"""Where a training step's time goes on the card: ``smollm-135m`` at full
width and depth (remat on, bf16 over f32 masters), 8 x 2048 tokens a step,
AdamW, with the blockwise softmax attention and with the maclaurin backend
(B8 in the forward, the plain twin's backward).

For each backend: two warm-up steps, the median of three steps timed with
CUDA events, then one step under ``torch.profiler`` (CPU and CUDA
activity): the device's busy time (the sum of its kernels' time; one
stream, so they do not overlap) against the step's time under the
profiler, and the kernels that take the most of it, with the share of
each group of kernels named below. Prints the card's name and power limit,
then one JSON line a backend.

    python3 scripts/train_profile.py        # on a machine with a CUDA card
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, T, TOP = 8, 2048, 12
# Kernel groups, by a substring of the kernel's name (first match wins).
GROUPS = (
    ("B8 maclaurin_attn", ("maclaurin",)),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "ampere_", "nvjet")),
    ("reduce", ("reduce",)),
    ("index / scatter / gather", ("index", "scatter", "gather")),
    ("copy / cast", ("copy", "cat", "CatArray")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.loader import lm_token_batches
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import OptimizerConfig, init_opt_state, make_train_step

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    base = get_config("smollm-135m")
    for backend in ("softmax", "maclaurin"):
        cfg = base.with_backend(backend)
        ocfg = OptimizerConfig(peak_lr=3e-3, warmup=5, total_steps=60)
        params = tf.init_params(cfg, seed=0, device=dev)
        state = init_opt_state(ocfg, params, device=dev)
        step_fn = make_train_step(cfg, ocfg)
        make = lm_token_batches(cfg.vocab_size, B, T, seed=42)
        batches = [
            {k: torch.from_numpy(x).to(dev) for k, x in make(s).items()} for s in range(6)
        ]

        def step(s):
            nonlocal params, state
            params, state, metrics = step_fn(params, state, batches[s], s)
            return metrics

        def timed(s) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(s)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        for s in range(2):
            step(s)
        torch.cuda.synchronize()
        ms = sorted(timed(s) for s in range(2, 5))
        build.reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = timed(5)
        launches = build.counts()
        kernels = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            own = getattr(e, "self_device_time_total", None)
            if own is None:
                own = e.self_cuda_time_total
            if own > 0:
                kernels[e.key] = (own / 1e3, e.count)
        busy = sum(t for t, _ in kernels.values())
        groups: dict[str, float] = {}
        for name, (t, _) in kernels.items():
            groups[group_of(name)] = groups.get(group_of(name), 0.0) + t
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        print(
            json.dumps(
                {
                    "backend": backend,
                    "batch": B,
                    "tokens": T,
                    "step_ms_median": ms[1],
                    "step_ms": ms,
                    "tokens_per_s": B * T / ms[1] * 1e3,
                    "profiled_step_ms": profiled_ms,
                    "device_busy_ms": busy,
                    "device_idle_share": max(0.0, 1.0 - busy / profiled_ms),
                    "kernel_launches": sum(n for _, n in kernels.values()),
                    "b8_launches": launches["maclaurin_attention"],
                    "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                    "top": [
                        {"kernel": name[:120], "ms": t, "count": n} for name, (t, n) in top
                    ],
                },
                sort_keys=False,
            ),
            flush=True,
        )
        del params, state, step_fn, batches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
