"""Plot training curves from a metrics JSONL file (port of
deepvcp_tpu/plot.py), on the port's train.metrics.load_metrics and
utils.vis.plot_metrics:

    python -m deepvcp_tpu_torch.plot metrics.jsonl [--out loss.png]
        [--keys loss rre_deg rte] [--smooth 10] [--summary]

--summary prints the per-epoch and eval averages as JSON lines. The JAX CLI
always draws the plot too; here --summary alone only prints, so that the
summary needs no matplotlib (--out draws it as well).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("metrics", help="metrics JSONL file")
    p.add_argument("--out", default=None, help="plot file (default loss.png, none with --summary)")
    p.add_argument("--keys", nargs="+", default=["loss", "rre_deg", "rte"])
    p.add_argument("--smooth", type=int, default=10)
    p.add_argument("--summary", action="store_true",
                   help="print per-epoch averages (print_loss.py parity)")
    args = p.parse_args(argv)

    from deepvcp_tpu_torch.train.metrics import load_metrics
    from deepvcp_tpu_torch.utils.vis import plot_metrics

    if args.summary:
        for r in load_metrics(args.metrics):
            if r.get("kind") in ("epoch", "eval"):
                vals = {k: round(v, 6) for k, v in r.items()
                        if isinstance(v, float) and k != "ts"}
                print(json.dumps({"kind": r["kind"], "epoch": r.get("epoch"), **vals}))
        if args.out is None:
            return
    out = plot_metrics(args.metrics, args.out or "loss.png", keys=args.keys, smooth=args.smooth)
    print(f"plot saved to {out}")


if __name__ == "__main__":
    main()
