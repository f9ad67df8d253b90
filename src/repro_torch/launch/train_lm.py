"""LM LoRA fine-tuning entry point on the model substrate (any --arch).

The port of ``examples/train_lm.py``: the same flags, defaults, seed,
synthetic document and printed lines, plus ``--device`` (default: the
card, which raises without one; ``--device cpu`` runs the plain path on
the CPU).  It runs the train step the dry run lowers: LoRA adapters and
AdamW on a frozen base, ``--microbatches`` of gradient accumulation and
each layer group rematerialised (``models.model.FwdOptions``' default),
at ``-smoke`` scale, or at the published widths with ``--full``.  The
base and the adapters are drawn from ``PRNGKey(0)`` in the config's
dtype, and the batch is one client's stack of the fixed random document
``(batch, seq + 1)`` that the adapters memorise.  As in the example, no
frontend is fed, so an architecture that reads one (whisper-large-v3,
qwen2-vl-72b) raises ``ValueError``.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --arch xlstm-125m \\
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_lm --full --steps 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import random as jr
from repro_torch.configs.registry import get
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the fine-tuning; returns the per-step ``losses``, ``grad_norms``
    and ``step_s`` (host seconds, the device synchronised after each
    step), the run's ``seconds`` and ``tokens_per_s``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="full config (published widths) instead of -smoke")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get(args.arch if args.full else args.arch + "-smoke")
    print(f"fine-tuning {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
          f"LoRA r={cfg.lora.rank})")
    key = jr.PRNGKey(0)
    params = M.init_params(cfg, key, device=device)
    adapters = M.stack_clients([M.init_adapters(cfg, key, params)])
    opt = adamw.init(adapters, n_clients=1)
    step = M.make_train_step(cfg, n_microbatches=args.microbatches,
                             lr=args.lr)

    # synthetic LM data: fixed random document the adapters memorize
    doc = torch.from_numpy(jr.randint(key, (args.batch, args.seq + 1), 4,
                                      cfg.vocab_size - 4)).long().to(device)
    batch = {"tokens": doc[None, :, :-1], "labels": doc[None, :, 1:]}

    losses, gnorms, step_s = [], [], []
    _sync(device)
    t0 = time.time()
    for s in range(args.steps):
        t1 = time.time()
        adapters, opt, m = step(params, adapters, opt, batch)
        _sync(device)
        step_s.append(time.time() - t1)
        losses.append(float(m["loss"][0]))
        gnorms.append(float(m["grad_norm"][0]))
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:4d}  loss={losses[-1]:.4f}  "
                  f"gnorm={gnorms[-1]:.2f}")
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"{args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s "
          f"{device.type.upper()})")
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "seconds": dt, "tokens_per_s": tok_s}


if __name__ == "__main__":
    main()
