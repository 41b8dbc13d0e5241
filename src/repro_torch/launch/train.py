"""LM training launcher.

A port of ``repro.launch.train``. On the host, a reduced config:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --device cpu --steps 100 --ckpt-dir /tmp/ckpt

Any registered ``--arch`` trains, as with the JAX launcher (llava-next
and whisper on seeded stub patches and frames). Without ``--device`` it
trains on the GPU and raises where there is none.
The data is ``FastTokenStream``'s (a batch is a pure function of the seed
and the step), so a run resumed from ``--ckpt-dir``'s latest commit
continues exactly.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.config import TrainConfig
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.tokens import FastTokenStream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train.loop import run_with_retries, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=("none", "full", "dots"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path; default: the GPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                       total_steps=args.steps, remat_policy=args.remat)
    stream = FastTokenStream(cfg.vocab, args.seq, args.batch, seed=0)

    def data_fn(i):
        """Step i's batch; llava-next's stub patch embeddings and whisper's
        stub frames drawn from a generator seeded with i, as the JAX
        launcher draws them."""
        b = stream.batch_at(i)
        if cfg.family == "vlm":
            rng = np.random.default_rng(i)
            b["patches"] = rng.normal(
                size=(args.batch, cfg.n_patches, cfg.d_model)).astype(
                    np.float32)
        elif cfg.family == "audio_encdec":
            rng = np.random.default_rng(i)
            b["frames"] = rng.normal(
                size=(args.batch, args.seq, cfg.d_model)).astype(np.float32)
        return b

    def job():
        return train(cfg, tcfg, data_fn, steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     accum=args.accum, device=device)

    _, _, history = run_with_retries(job)
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    return history


if __name__ == "__main__":
    main()
