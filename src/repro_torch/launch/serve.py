"""Serving: batched autoregressive decode on the model substrate.

The port of ``examples/serving.py``: the same flags, defaults and
printed lines, plus ``--device`` (default: the card; ``--device cpu``
runs the plain path on the CPU).  It loads the ``-smoke`` form of
``--arch`` (any config of ``configs.registry``: the dense ones,
``kimi-k2-1t-a32b`` and ``llama4-maverick-400b-a17b`` with their
mixture of experts, ``minicpm3-4b`` with latent attention,
``jamba-1.5-large-398b`` with its Mamba layers, ``xlstm-125m`` with its
mLSTM and sLSTM layers, the encoder-decoder ``whisper-large-v3`` and
the vision-language ``qwen2-vl-72b``), draws the base and adapters from
``PRNGKey(0)`` in the config's dtype, fills the cache (the attention
layers' k and v, the recurrent layers' states) by running the prompt
through the serve step one token at a time, then decodes ``--steps``
tokens per request, sampled at ``--temperature``.  As in the example,
no frontend is fed: whisper's cross caches stay the zeros of
``init_cache`` (so its cross-attention adds nothing) and qwen2-vl sees
no patches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --batch 4 --steps 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-1.5-large-398b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    help="any name of configs.registry.all_names()")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get(args.arch + "-smoke")
    print(f"serving {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"pattern={[m for m, _ in cfg.pattern]}")
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, device=device)
    adapters = M.init_adapters(cfg, key, params)

    B, P, S = args.batch, args.prompt_len, args.prompt_len + args.steps
    prompts = torch.from_numpy(
        jr.randint(key, (B, P), 4, cfg.vocab_size - 4)).long().to(device)

    # prefill: cache created by running the prompt through decode steps
    # (smoke-scale; the one-pass prefill is M.make_prefill_step)
    cache = M.init_cache(cfg, B, S, device=device)
    serve = M.make_serve_step(cfg)

    t0 = time.time()
    for p in range(P):
        logits, cache = serve(params, adapters, cache, prompts[:, p:p + 1], p)
    _sync(device)
    print(f"prefill({P} tokens, sequential smoke path): "
          f"{time.time()-t0:.2f}s")

    t0 = time.time()
    out = []
    tok = torch.argmax(logits, -1)[:, None]
    for s in range(args.steps):
        key, k = jr.split(key)
        logits, cache = serve(params, adapters, cache, tok, P + s)
        tok = jr.categorical(k, logits / args.temperature)[:, None]
        out.append(tok)
    _sync(device)
    dt = time.time() - t0
    gen = torch.cat(out, 1)
    print(f"decoded {args.steps} tokens × {B} requests in {dt:.2f}s "
          f"({B*args.steps/dt:.1f} tok/s)")
    print("sample token ids:", gen[0, :12].tolist())
    return {"prompts": prompts.cpu().numpy().astype(np.int32),
            "tokens": gen.cpu().numpy(), "decode_s": dt}


if __name__ == "__main__":
    main()
