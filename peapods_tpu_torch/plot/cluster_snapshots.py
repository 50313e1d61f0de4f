#!/usr/bin/env python
"""Render overlap-cluster snapshots stored in sweep ``.npz`` files.

The port's own copy of ``peapods_tpu/plot/cluster_snapshots.py``.  Reads
the snapshot npz schema both engines' ``run_sweep`` write (keys
``<prefix>_snapshot_{sweep_ids,mode_idxs,cluster_ids,spins,system_ids}``,
``<prefix>_lattice_shape``, optional ``..._blue_ids`` for CMR and a global
``temperatures`` array) and keeps the reference's rendering conventions —
CMR greys in red under blues in blue, other modes in green, clusters below
10 sites left white.

Usage:
    python -m peapods_tpu_torch.plot.cluster_snapshots results.npz
    python -m peapods_tpu_torch.plot.cluster_snapshots results.npz -s 3 -t 5
    python -m peapods_tpu_torch.plot.cluster_snapshots results.npz --all-temps
    python -m peapods_tpu_torch.plot.cluster_snapshots results.npz -o out.png
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field

import numpy as np

MIN_CLUSTER_SIZE = 10
RGB = {
    "white": (1.0, 1.0, 1.0),
    "green": (0.2, 0.8, 0.3),   # non-CMR cluster sites
    "red": (0.9, 0.2, 0.2),     # CMR grey clusters
    "blue": (0.2, 0.5, 1.0),    # CMR blue clusters (drawn on top)
}

# npz schema: attribute -> key suffix under the run prefix
_KEYS = {
    "sweep_ids": "snapshot_sweep_ids",
    "mode_idxs": "snapshot_mode_idxs",
    "cluster_ids": "snapshot_cluster_ids",
    "spins": "snapshot_spins",
    "system_ids": "snapshot_system_ids",
}


@dataclass
class SnapshotSet:
    """All snapshot arrays of one run, plus lattice/temperature metadata."""

    sweep_ids: np.ndarray
    mode_idxs: np.ndarray
    cluster_ids: np.ndarray  # [n_snaps, n_temps, n_spins]
    spins: np.ndarray
    system_ids: np.ndarray
    shape: tuple
    blue_ids: np.ndarray | None = None
    temperatures: np.ndarray | None = None
    _cache: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_npz(cls, path):
        data = np.load(path, allow_pickle=True)
        suffix = "_" + _KEYS["sweep_ids"]
        prefixes = [k[: -len(suffix)] for k in data.files if k.endswith(suffix)]
        if not prefixes:
            raise SystemExit("no snapshot data found in npz")
        p = prefixes[0]
        fields = {a: data[f"{p}_{s}"] for a, s in _KEYS.items()}
        blue = f"{p}_snapshot_blue_ids"
        return cls(
            shape=tuple(data[f"{p}_lattice_shape"]),
            blue_ids=data[blue] if blue in data.files else None,
            temperatures=(
                data["temperatures"] if "temperatures" in data.files else None
            ),
            **fields,
        )

    @property
    def n_snaps(self):
        return len(self.sweep_ids)

    @property
    def n_temps(self):
        return self.cluster_ids.shape[1]

    @property
    def is_cmr(self):
        return self.blue_ids is not None

    def panel_title(self, snap, temp):
        t = (
            f"T={self.temperatures[temp]:.4f}"
            if self.temperatures is not None
            else f"t_idx={temp}"
        )
        return f"sweep {self.sweep_ids[snap]}, {t}"

    def rgb(self, snap, temp):
        """``[H, W, 3]`` panel image.

        Sites belonging to clusters of >= MIN_CLUSTER_SIZE sites are
        colored; CMR paints grey clusters red then blue clusters over them.
        """
        if len(self.shape) != 2:
            raise ValueError(
                f"only 2D lattices supported, got shape {self.shape}"
            )
        layers = [(self.cluster_ids, "red" if self.is_cmr else "green")]
        if self.is_cmr:
            layers.append((self.blue_ids, "blue"))
        img = np.full(self.cluster_ids.shape[-1], 0, np.int8)
        colors = [RGB["white"]]
        for ids, color in layers:
            labels = ids[snap, temp]
            _, inv, counts = np.unique(
                labels, return_inverse=True, return_counts=True
            )
            img[counts[inv] >= MIN_CLUSTER_SIZE] = len(colors)
            colors.append(RGB[color])
        return np.asarray(colors, float)[img].reshape(*self.shape, 3)


def _draw(ax, snaps, snap, temp):
    ax.imshow(snaps.rgb(snap, temp), interpolation="nearest", origin="lower")
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_title(snaps.panel_title(snap, temp), fontsize=9)


def render(snaps, panels, title):
    """Lay ``panels`` (list of (snap, temp) pairs) onto a grid figure."""
    import matplotlib.pyplot as plt

    if len(panels) == 1:
        fig, ax = plt.subplots(figsize=(6, 6))
        _draw(ax, snaps, *panels[0])
        return fig
    ncols = min(4, len(panels))
    nrows = -(-len(panels) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows))
    flat = np.atleast_1d(axes).ravel()
    for ax, panel in zip(flat, panels):
        _draw(ax, snaps, *panel)
    for ax in flat[len(panels):]:
        ax.axis("off")
    fig.suptitle(title, fontsize=12)
    return fig


def main(argv=None):
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser(description="Plot cluster snapshots")
    ap.add_argument("npz", help="Path to .npz file")
    ap.add_argument("-s", "--snap", type=int, default=-1)
    ap.add_argument("-t", "--temp", type=int, default=0)
    ap.add_argument("--all-temps", action="store_true")
    ap.add_argument("--all-snaps", action="store_true")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    try:
        snaps = SnapshotSet.from_npz(args.npz)
    except SystemExit as e:
        print(e, file=sys.stderr)
        raise
    s = args.snap % snaps.n_snaps
    t = args.temp % snaps.n_temps
    mode = "CMR" if snaps.is_cmr else "overlap"

    if args.all_temps:
        panels = [(s, ti) for ti in range(snaps.n_temps)]
        title = f"{mode} clusters — snapshot {s}"
    elif args.all_snaps:
        panels = [(si, t) for si in range(snaps.n_snaps)]
        title = f"{mode} clusters — {snaps.panel_title(0, t).split(', ')[1]}"
    else:
        panels, title = [(s, t)], None

    fig = render(snaps, panels, title)
    fig.tight_layout()
    if args.output:
        fig.savefig(args.output, dpi=200, bbox_inches="tight")
        print(f"saved to {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
