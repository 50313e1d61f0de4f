"""Sweeps a second of the 256^2 SW observe run at T_c (``chip_smoke.py``'s
phase 20 run) and the host time of one winding-flags call, in the checkout
that ``--root`` names.

    python3 tools/observe_rate.py [--root DIR] [--label NAME] [--sweeps N]
                                  [--calls K] [--out FILE]

Imports ``peapods_tpu_torch`` of ``--root`` (default: this checkout), whose
kernels build under that checkout.  The run is ``Ising((256, 256),
temperatures=[T_c], seed=3)`` with ``cluster_update_interval=1,
cluster_mode="sw", cluster_action="observe"``: one warm call of ``N``
sweeps, then ``K`` timed calls of ``N`` sweeps each on the host clock
(synchronised before and after).  Then the host time of
``winding.winding_flags`` on one 256^2 graph at the bond-percolation
threshold (the median of five rounds of 64 calls queued without a
synchronisation, after one round to warm: the wrapper's checks,
allocations and launches, while the card runs behind).
Prints one JSON line (label, root, card, each call's sweeps/s and their
median, the winding launches a sweep, the wrapper's host microseconds a
call) and appends it to ``--out``.  To compare two checkouts on one card
and host, run it in one machine on each in turn, A, B, B, A.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

T_C = 2.0 / np.log(1.0 + np.sqrt(2.0))
KW = dict(cluster_update_interval=1, cluster_mode="sw", cluster_action="observe")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweeps", type=int, default=1024)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("observe_rate: needs a CUDA device")
    from peapods_tpu_torch import Ising
    from peapods_tpu_torch.ops import cluster, winding

    dev = torch.device("cuda")
    model = Ising((256, 256), temperatures=np.array([T_C], np.float32), seed=3, device=dev)
    model.sample(args.sweeps, "metropolis", **dict(KW, warmup_ratio=0.0))
    torch.cuda.synchronize()
    for k in winding.LAUNCHES:
        winding.LAUNCHES[k] = 0
    rates = []
    for _ in range(args.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(args.sweeps, "metropolis", **dict(KW, warmup_ratio=0.0))
        torch.cuda.synchronize()
        rates.append(args.sweeps / (time.perf_counter() - t0))
    launches = {k: v / (args.sweeps * args.calls) for k, v in winding.LAUNCHES.items() if v}

    g = torch.Generator(device=dev).manual_seed(256)
    masks = torch.rand((1, 256 * 256, 2), device=dev, generator=g) < 0.5
    labels = cluster.connected_components(masks, (256, 256))
    errors = torch.zeros(1, dtype=torch.int32, device=dev)
    host = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(64):
            winding.winding_flags(masks, labels, (256, 256), errors=errors)
        host.append((time.perf_counter() - t0) * 1e6 / 64)
    torch.cuda.synchronize()
    host_us = float(np.median(host[1:]))

    rec = dict(label=args.label or root.name, root=str(root), card=card_line(),
               sweeps=args.sweeps, rates=rates, sweeps_s=float(np.median(rates)),
               winding_launches_per_sweep=launches, winding_host_us=host_us)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
