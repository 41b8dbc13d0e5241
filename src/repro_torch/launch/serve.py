"""Serving driver: batched prefill, then decode.

A port of ``repro.launch.serve``. Demo on the host (reduced config; any
registered ``--arch`` whose prompt is tokens alone: dense, dbrx's ``moe``,
deepseek-v2's ``mla_moe``, xlstm's ``ssm``, recurrentgemma's ``hybrid``;
llava-next's patches and whisper's frames go through ``lm.prefill_step`` /
``lm.decode_step`` directly, as in the JAX package):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --device cpu --requests 8 --max-new 16

Without ``--device`` it runs on the GPU and raises where there is none.
Prefill attention goes through the flash-attention kernel on the GPU;
decode attends one token against the cache in plain PyTorch.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import lm


def merge_caches(full: List[Dict], prefill: List[Dict]) -> List[Dict]:
    """Copy prefill caches into the decode caches ``full`` in place, leaf by
    leaf, as the JAX package's ``serve_batch`` merges them: a leaf of the
    same shape is copied whole (a recurrent state, a ``lattn`` ring that
    the prompt filled, whisper's cross k/v), otherwise into the leading
    slice of each axis that differs (k/v ``[n, B, Hkv, S, dh]`` and MLA's
    ``[n, B, S, r]`` along S). Returns ``full``."""
    for dst_seg, src_seg in zip(full, prefill):
        for key, dst_layer in dst_seg.items():
            for name, dst in dst_layer.items():
                src = src_seg[key][name]
                if dst.shape != src.shape:
                    dst = dst[tuple(slice(0, n) for n in src.shape)]
                dst.copy_(src)
    return full


def serve_batch(cfg, params: lm.LM, prompts, max_new: int, cache_size: int,
                dtype=torch.float32, greedy: bool = True,
                generator: Optional[torch.Generator] = None):
    """Prefill a batch of equal-length prompts ``[B, S]``, then decode
    ``max_new`` tokens (the first is the argmax of the prefill's logits).

    ``greedy=False`` samples each decoded token from the softmax of its
    logits with ``generator`` (a ``torch.Generator`` on the model's device;
    by default one seeded with 0); the first token stays the argmax, as in
    the JAX package. Returns the tokens ``[B, max_new]`` as numpy and
    timings: ``prefill_s`` (host clock, up to the first token on the
    device), ``decode_s`` and ``tok_per_s`` (the decode steps)."""
    device = params.embed.tokens.device
    prompts = torch.as_tensor(prompts, device=device)
    b, s = prompts.shape
    if s + max_new - 1 > cache_size:
        raise ValueError(f"cache_size={cache_size} holds fewer than the "
                         f"{s + max_new - 1} positions the batch needs")
    if not greedy and generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def pick(logits, sample):
        if not sample:
            return torch.argmax(logits[:, -1], dim=-1)[:, None]
        probs = torch.softmax(logits[:, -1], dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    t0 = time.perf_counter()
    logits, pcaches = lm.prefill_step(params, {"tokens": prompts}, cfg,
                                      dtype=dtype)
    # move prefill caches into full-size decode caches
    cache = merge_caches(lm.init_cache(cfg, b, cache_size, dtype, device),
                         pcaches)
    del pcaches
    tok = pick(logits, sample=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(max_new - 1):
        logits, cache = lm.decode_step(params, cache, tok, s + i, cfg,
                                       dtype=dtype)
        tok = pick(logits, sample=not greedy)
        out.append(tok)
    gen = torch.cat(out, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    return gen, {"prefill_s": prefill_s, "decode_s": dt,
                 "tok_per_s": b * (max_new - 1) / max(dt, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path; default: the GPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    params = lm.init_params(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)))
    gen, stats = serve_batch(cfg, params, prompts, args.max_new,
                             cache_size=args.prompt_len + args.max_new)
    print(f"generated {gen.shape} tokens; "
          f"{stats['tok_per_s']:.1f} tok/s decode")
    return gen


if __name__ == "__main__":
    main()
