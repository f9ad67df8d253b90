"""The dry run's records as Markdown: one row a pair of one mesh, with
its predicted peak GiB a device, the dominant roofline term and its
seconds, the collective bytes a device and the trace seconds; failures
listed after the table.  ``grid`` prints one row an arch and one column
a shape instead (peak GiB, dominant term and seconds, trace seconds).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python tools/dryrun_table.py single [grid]     # or: multi

Reads ``experiments/dryrun_torch/*_{mesh}_baseline.json``.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def grid(recs):
    cells = {}
    for r in recs:
        if r["status"] == "ok":
            roof = r["roofline"]
            dom = roof["dominant"]
            cells[r["arch"], r["shape"]] = (
                f"{r['memory']['peak_bytes_per_device'] / 2 ** 30:.2f} · "
                f"{dom[:4]} {roof[dom + '_s']:.3g} s · {r['trace_s']:.0f}")
        else:
            cells[r["arch"], r["shape"]] = "fail"
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---" * (len(SHAPES) + 1) + "|")
    for arch in sorted({a for a, _ in cells}):
        print(f"| {arch} | " + " | ".join(
            cells.get((arch, s), "—") for s in SHAPES) + " |")


def main(mesh: str, form: str = "rows"):
    recs = [json.loads(p.read_text()) for p in sorted(
        (ROOT / "experiments" / "dryrun_torch").glob(
            f"*_{mesh}_baseline.json"))]
    if form == "grid":
        return grid(recs)
    print("| arch | shape | peak GiB/device | dominant: seconds | "
          "collective GB/device | replicated ops | trace s |")
    print("|---|---|---|---|---|---|---|")
    fails = []
    for r in recs:
        if r["status"] != "ok":
            fails.append(r)
            continue
        roof = r["roofline"]
        dom = roof["dominant"]
        coll = sum(v["bytes"] for v in r["collectives"].values())
        print(f"| {r['arch']} | {r['shape']} | "
              f"{r['memory']['peak_bytes_per_device'] / 2 ** 30:.2f} | "
              f"{dom}: {roof[dom + '_s']:.4g} | {coll / 1e9:.3g} | "
              f"{', '.join(o.split('.')[1] for o in r['replicated_ops']) or '—'}"
              f" | {r['trace_s']} |")
    print(f"\n{len(recs) - len(fails)} ok, {len(fails)} failed")
    for r in fails:
        print(f"- {r['arch']} × {r['shape']}: {r['error'][:200]}")


if __name__ == "__main__":
    main(*(sys.argv[1:] or ["single"]))
