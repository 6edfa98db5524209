"""End-to-end training driver (port of ``repro/launch/train.py``), on the
card unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \\
      --smoke --device cpu --steps 100 --batch 8 --seq 64 --ckpt-dir CKPT

Deterministic data (the batch at a step is a function of the seed and the
step), float32 master weights, periodic asynchronous checkpoints in the
reference's layout and exact resume from the latest one, optional int8
gradient compression and gradient accumulation.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (
    init_train_state,
    make_train_step,
    train_state_from_numpy,
    train_state_to_numpy,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
                      seed=args.seed, img_tokens=cfg.cross_kv_len, d_model=cfg.d_model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params, opt = init_train_state(cfg, gen, dev)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, extra = restore_checkpoint(args.ckpt_dir, train_state_to_numpy(params, opt, cfg),
                                          device=dev)
        params, opt = train_state_from_numpy(state, cfg, dev)
        start = extra["data_step"]
        print(f"resumed from step {start}")

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=5, total_steps=max(args.steps, 10))
    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum,
                              compress_grads=args.compress_grads)
    t0 = time.time()
    pending = None
    for step in range(start, start + args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at(dcfg, step).items()}
        params, opt, m = step_fn(params, opt, batch)
        if (step + 1) % args.log_every == 0:
            loss = float(m["loss"])         # waits for the step
            dt = (time.time() - t0) / args.log_every
            print(f"step {step + 1}: loss={loss:.4f} gnorm={float(m['grad_norm']):.3f} "
                  f"lr={float(m['lr']):.2e} {dt * 1e3:.0f} ms/step", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(args.ckpt_dir, step + 1,
                                      train_state_to_numpy(params, opt, cfg),
                                      extra={"data_step": step + 1}, block=False)
    if pending is not None:
        pending.join()
    print("done")


if __name__ == "__main__":
    main()
