"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch smollm-135m --reduced --steps 6                     # on the CPU

The port of ``repro/launch/train.py``, with its flags and log lines, and
``--device`` (CUDA unless named; raising when there is no card). Wires
together: config -> init (or restore from LATEST) -> train step ->
step-resumable data (``lm_token_batches``, seed 42) -> async checkpoints
every ``--ckpt-every`` steps -> a final save. One process on one device:
the reference's multi-host mesh has no counterpart here.

Fault-tolerance drill (``--simulate-failure N``): the process exits with
code 42 at step N without saving, and a restart with the same flags
resumes from the last committed checkpoint, replaying the data stream
from the restored step.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.data.loader import lm_token_batches
from repro_torch.models.transformer import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.train_step import OptimizerConfig, init_opt_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ocfg = OptimizerConfig(
        peak_lr=args.lr, warmup=max(5, args.steps // 20), total_steps=args.steps,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
    )

    start_step = 0
    params = init_params(cfg, seed=0, device=dev)
    opt_state = init_opt_state(ocfg, params, device=dev)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.ckpt_dir and (last := ckpt.latest_step(args.ckpt_dir)) is not None:
        like = {"params": params, "opt": opt_state}
        state = ckpt.restore(args.ckpt_dir, last, like, shardings=dev)
        params, opt_state = state["params"], state["opt"]
        start_step = last + 1
        print(f"[train] resumed from step {last}", flush=True)

    step_fn = make_train_step(cfg, ocfg)
    make_batch = lm_token_batches(cfg.vocab_size, args.batch, args.seq, seed=42)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    t_last, tok_per_step = clock(), args.batch * args.seq
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            now = clock()
            dt, t_last = now - t_last, now
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({args.log_every * tok_per_step / max(dt, 1e-9):.0f} tok/s)",
                  flush=True)
        if saver and step > 0 and step % args.ckpt_every == 0:
            saver.save(step, {"params": params, "opt": opt_state})
        if args.simulate_failure is not None and step == args.simulate_failure:
            print(f"[train] SIMULATED NODE FAILURE at step {step} — dying "
                  f"uncleanly (restart me to resume)", flush=True)
            sys.exit(42)
    if saver:
        saver.save(args.steps - 1, {"params": params, "opt": opt_state})
        saver.wait()
    print("[train] done", flush=True)


if __name__ == "__main__":
    main()
