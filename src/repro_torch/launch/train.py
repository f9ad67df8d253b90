"""Federated training driver (production CLI for the paper's experiments).

The port of ``repro/launch/train.py``: the same flags, defaults, printed
lines and ``history.json`` layout, plus ``--device`` (default: the card;
``--device cpu`` runs the plain path on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --task genomic \\
      --method llm-qfl --rounds 8 --clients 5 --backend aersim \\
      --select-frac 0.2 --regulation adaptive --out experiments/runs/demo

Writes run history (per-round JSON) + final summary.  This is Algorithm 1
end to end: synthetic-data build → round-1 LLM LoRA fine-tuning →
regulated quantum training → aggregation → termination.  The device is
handed to ``Orchestrator(..., device=)`` and is not part of
``RunConfig``, so ``history.json["config"]`` has the JAX package's keys.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

from repro_torch.core import Orchestrator, RunConfig
from repro_torch.data.tasks import build_task


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="genomic",
                    choices=["genomic", "tweets"])
    ap.add_argument("--method", default="llm-qfl",
                    choices=["qfl", "llm-qfl"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--train-size", type=int, default=250)
    ap.add_argument("--select-frac", type=float, default=1.0)
    ap.add_argument("--regulation", default="adaptive")
    ap.add_argument("--maxiter0", type=int, default=10)
    ap.add_argument("--optimizer", default="nelder-mead",
                    choices=["nelder-mead", "spsa"])
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "batched"])
    ap.add_argument("--n-qubits", type=int, default=4)
    ap.add_argument("--backend", default="exact",
                    choices=["exact", "fake", "aersim", "real"])
    ap.add_argument("--llm", default="tiny-llm")
    ap.add_argument("--llm-steps", type=int, default=30)
    ap.add_argument("--non-iid-alpha", type=float, default=0.0)
    ap.add_argument("--epsilon", type=float, default=1e-3)
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)

    t0 = time.time()
    task = build_task(args.task, n_clients=args.clients,
                      train_size=args.train_size,
                      non_iid_alpha=args.non_iid_alpha, seed=args.seed,
                      n_features=args.n_qubits)
    rc = RunConfig(
        method=args.method, select_frac=args.select_frac,
        regulation=args.regulation, maxiter0=args.maxiter0,
        n_rounds=args.rounds, epsilon=args.epsilon,
        optimizer=args.optimizer, engine=args.engine,
        n_qubits=args.n_qubits, backend=args.backend,
        llm_name=args.llm, llm_steps=args.llm_steps,
        early_stop=not args.no_early_stop, seed=args.seed)
    res = Orchestrator(task, rc, device=args.device).run()

    for r in res.rounds:
        print(f"round {r.t:3d}  server_loss={r.server_loss:.4f} "
              f"val_acc={r.server_val_acc:.3f} "
              f"test_acc={r.server_test_acc:.3f} "
              f"maxiters={r.maxiters} selected={r.selected}")
    print(f"done in {time.time()-t0:.1f}s "
          f"(LLM fine-tune {res.llm_finetune_time_s:.1f}s, "
          f"early_stop={res.terminated_early})")

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        hist = {
            "config": dataclasses.asdict(rc),
            "rounds": [dataclasses.asdict(r) for r in res.rounds],
            "llm_losses": res.llm_losses, "llm_f1": res.llm_f1,
            "terminated_early": res.terminated_early,
            "theta_g": [float(x) for x in res.theta_g],
        }
        (out / "history.json").write_text(json.dumps(hist, indent=1))
        print(f"history → {out/'history.json'}")
    return res


if __name__ == "__main__":
    main()
