"""Sweeps a second of the 4D +-J glass (``chip_smoke.py``'s phase 38a run) in
the checkout that ``--root`` names.

    python3 tools/table_rate.py [--root DIR] [--label NAME] [--sweeps N]
                                [--calls K] [--out FILE]

Imports ``peapods_tpu_torch`` of ``--root`` (default: this checkout), whose
kernels build under that checkout.  The run is ``Ising((10, 10, 10, 10),
couplings="bimodal", temperatures=linspace(1.6, 2.4, 12), n_replicas=2,
n_disorder=16, seed=38)`` (3.84 M spins, the table form: four dimensions)
with full-ladder PT every sweep, ``houdayer+cmr`` SW overlap moves every
sweep and SW every 2 sweeps with cluster statistics: one warm call of ``N``
sweeps, then ``K`` timed calls of ``N`` sweeps each on the host clock
(synchronised before and after).  Prints one JSON line (label, root, card,
each call's sweeps/s and their median) and appends it to ``--out``.  To
compare two checkouts on one card and host, run it in one machine on each
in turn, A, B, B, A.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

KW = dict(pt_interval=1, pt_schedule="full_ladder", overlap_cluster_update_interval=1,
          overlap_cluster_build_mode="houdayer+cmr", overlap_cluster_mode="sw",
          cluster_update_interval=2, cluster_mode="sw", collect_cluster_stats=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweeps", type=int, default=512)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        sys.exit("table_rate: needs a CUDA device")
    from observe_rate import card_line
    from peapods_tpu_torch import Ising

    model = Ising((10, 10, 10, 10), couplings="bimodal", temperatures=np.linspace(1.6, 2.4, 12),
                  n_replicas=2, n_disorder=16, seed=38, device=torch.device("cuda"))
    model.sample(args.sweeps, "metropolis", **dict(KW, warmup_ratio=0.0))
    rates = []
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(args.sweeps, "metropolis", **dict(KW, warmup_ratio=0.0))
        torch.cuda.synchronize()
        rates.append(args.sweeps / (time.perf_counter() - t0))
    rec = dict(label=args.label or root.name, root=str(root), card=card_line(),
               sweeps=args.sweeps, rates=rates, sweeps_s=float(np.median(rates)))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
