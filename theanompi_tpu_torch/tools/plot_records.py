"""Plot training records — the reference's offline matplotlib plotting.

Theano-MPI dumped per-rank ``inforec`` record files for offline plotting of
cost/error/throughput curves; this reads the port's
``inforec_rank*.jsonl`` (or ``.npy``) dumps from a record dir — or one
record file directly — and writes PNG curves: cost, error, throughput,
and the per-section time breakdown (every bucket in ``PHASES`` of
``utils/telemetry.py``, so new buckets plot automatically).

Usage: python -m theanompi_tpu_torch.tools.plot_records
           <record_dir_or_file> [out.png]

The port's counterpart of the JAX package's ``plot_records``; numpy and
matplotlib, imported when used, so the module loads without them.
"""

import json
import os
import sys

from ..utils.telemetry import PHASES


def _load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _load_npy(path):
    import numpy as np
    return np.load(path, allow_pickle=True).tolist()


def load_records(path):
    """Records from a directory of per-rank dumps, or from one ``.jsonl`` /
    ``.npy`` file directly.  JSONL wins in a directory (it carries the
    epoch/validation records too); ``.npy`` is the fallback."""
    if os.path.isfile(path):
        return _load_npy(path) if path.endswith(".npy") \
            else _load_jsonl(path)
    recs = []
    for name in sorted(os.listdir(path)):
        if name.startswith("inforec_rank") and name.endswith(".jsonl"):
            recs.extend(_load_jsonl(os.path.join(path, name)))
    if not recs:
        for name in sorted(os.listdir(path)):
            if name.startswith("inforec_rank") and name.endswith(".npy"):
                recs.extend(_load_npy(os.path.join(path, name)))
    return recs


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    src = argv[0]
    out_dir = src if os.path.isdir(src) else os.path.dirname(src) or "."
    out = argv[1] if len(argv) > 1 else os.path.join(out_dir, "curves.png")

    recs = load_records(src)
    train = [r for r in recs if "cost" in r]
    val = [r for r in recs if "val_cost" in r]
    if not train and not val:
        print(f"no records found in {src}")
        return 1

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 4, figsize=(20, 4))
    if train:
        it = [r["iter"] for r in train]
        axes[0].plot(it, [r["cost"] for r in train], label="train cost")
        axes[1].plot(it, [r["error"] for r in train], label="train err")
        axes[2].plot(it, [r.get("images_per_sec", 0) for r in train],
                     label="img/s")
        # per-section time breakdown: every recorder bucket with signal
        # (the canonical section list — stage/compile included — comes
        # from telemetry.PHASES, the one source of truth)
        for s in PHASES:
            key = "t_" + s
            ys = [r.get(key, 0.0) for r in train]
            if any(y > 0 for y in ys):
                axes[3].plot(it, ys, label=key)
    if val:
        it = [r["iter"] for r in val]
        axes[0].plot(it, [r["val_cost"] for r in val], "o-", label="val cost")
        axes[1].plot(it, [r["val_error"] for r in val], "o-",
                     label="val top-1 err")
        axes[1].plot(it, [r["val_error_top5"] for r in val], "s--",
                     label="val top-5 err")
    for ax, title in zip(axes, ("cost", "error", "throughput",
                                "time breakdown (s per print window)")):
        ax.set_xlabel("iteration")
        ax.set_title(title)
        if ax.get_legend_handles_labels()[0]:
            ax.legend()
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out} ({len(train)} train / {len(val)} val records)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
