"""Time the overlap moves' two forms on the lattices that both take, on one
NVIDIA GPU: the walk form's offset-table instance (``csrc/overlap.cu``
``kTable``: up to six offsets of three extents, labelled by ``cc_link``, or
``fk_link`` on the triangular lattice) and the neighbour-table form
(``ov_bonds_table`` ... ``houdn_finish_table``, labelled by
``cc_table_link``: a graph's union-find in shared memory, one launch).

    python3 tools/probe_overlap_forms.py [--rounds N] [--json PATH]

On each lattice (tri64, bcc16, fcc16 and the odd cube 15^3: the per-sweep
replica runs of ``chip_smoke.py`` phases 34 and 36), random +-J spins of
config 5's counts (R = 4 replicas x 24 temperatures x 8 realizations), each
move (pair Houdayer SW, Houdayer(4) Wolff, Joerg Wolff and SW, CMR Wolff
and SW) runs in both forms and in its plain version on copies of one state:
spins and labels (CMR's blue labels too) must be bitwise equal.  The table
form is taken on these lattices by marking a copy of the lattice as a table
lattice, so ``overlap.overlap_event`` launches it on the lattice's int32
neighbour tables.  Then each form's move is profiled over ``--rounds``
calls, the forms alternating A B B A: every kernel's device time a launch
and the move's device time, the sum over its kernels.  Prints one line a
lattice and move, and the card's name and power limit; writes every
measurement as JSON to ``--json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SCOPE_PREFIX, card_line, ea_random_state, move_tables  # noqa: E402
from peapods_tpu_torch.ops import overlap  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice  # noqa: E402

LATTICES = {
    "tri64": ((64, 64), GEOMETRY_OFFSETS["triangular"]),
    "bcc16": ((16, 16, 16), GEOMETRY_OFFSETS["bcc"]),
    "fcc16": ((16, 16, 16), GEOMETRY_OFFSETS["fcc"]),
    "cube15": ((15, 15, 15), None),
}
# (kind, group size, wolff)
MOVES = (("houdayer", 2, False), ("houdayer", 4, True), ("jorg", 2, True),
         ("jorg", 2, False), ("cmr", 2, True), ("cmr", 2, False))
R, T, D = 4, 24, 8


def table_view(lat):
    """A copy of ``lat`` that the wrappers take as a table lattice."""
    view = copy.copy(lat)
    view.table = True
    return view


def kernel_name(key):
    m = re.search(r"(\w+?)_kernel", key)
    return m.group(1) if m else key[:40]


def profile(fn, rounds):
    """Device us a launch by kernel (CPU events and profiling scopes left
    out, as ``chip_smoke.py`` ``device_time`` does), and the device us of
    one ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    per, counts = {}, {}
    for ev in prof.key_averages():
        if (ev.self_device_time_total <= 0 or ev.device_type == DeviceType.CPU
                or ev.key.startswith(SCOPE_PREFIX)):
            continue
        k = kernel_name(ev.key)
        per[k] = per.get(k, 0.0) + ev.self_device_time_total
        counts[k] = counts.get(k, 0) + ev.count
    return {k: per[k] / counts[k] for k in per}, sum(per.values()) / rounds


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--json", default=str(ROOT / "build" / "probe_overlap_forms.json"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_overlap_forms: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(26)
    results = []
    for name, (shape, offsets) in LATTICES.items():
        lat = Lattice(shape, offsets)
        if lat.table or lat.axes_form:
            raise AssertionError(f"{name} does not take the walk form's kTable instance")
        view, tables = table_view(lat), lat.device_tables(dev)
        x = ea_random_state(lat, dev, rng, d=D, n_replicas=R, n_temps=T)
        for kind, g, wolff in MOVES:
            tab = move_tables(rng, D, R, T, lat.n_spins, kind, wolff, g, dev)
            args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
            forms = {"kTable": dict(shape=lat), "table": dict(shape=view, tables=tables)}
            outs = {}
            for form, kw in forms.items():
                s = x["spins"].clone()
                outs[form] = (s, overlap.overlap_event(s, *args, kind=kind, wolff=wolff,
                                                       with_labels=True, **kw))
            s = x["spins"].clone()
            outs["plain"] = (s, overlap.overlap_event_plain(s, *args, kind=kind, wolff=wolff,
                                                            shape=lat, with_labels=True))
            torch.cuda.synchronize()
            ref_s, ref_g = outs["plain"]
            for form, (s, gr) in outs.items():
                same = torch.equal(s, ref_s) and torch.equal(gr.labels, ref_g.labels) and (
                    kind != "cmr" or torch.equal(gr.blue, ref_g.blue))
                if not same:
                    raise AssertionError(f"{name} {kind} g {g} wolff {wolff}: the {form} "
                                         "form differs from the plain version")
            times = {f: [] for f in forms}
            for form in ("kTable", "table", "table", "kTable"):
                kw = forms[form]
                s = x["spins"].clone()
                times[form].append(profile(lambda s=s, kw=kw: overlap.overlap_event(
                    s, *args, kind=kind, wolff=wolff, **kw), a.rounds))
            rec = dict(lattice=name, n_spins=lat.n_spins, n_neighbors=lat.n_neighbors,
                       kind=kind, g=g, wolff=wolff)
            for form, runs in times.items():
                rec[form] = dict(move_us=[t for _, t in runs],
                                 kernels_us={k: [r[0].get(k) for r in runs]
                                             for k in runs[0][0]})
            results.append(rec)
            mv = {f: float(np.mean(rec[f]["move_us"])) for f in forms}
            print(f"[forms] {name} ({lat.n_spins} sites, {lat.n_neighbors} offsets, "
                  f"{D} x {T} x R = {R}) {kind} g {g} {'wolff' if wolff else 'sw'}: bitwise "
                  f"the plain version in both forms; device us a move kTable "
                  f"{rec['kTable']['move_us'][0]:.3f} / {rec['kTable']['move_us'][1]:.3f}, "
                  f"table {rec['table']['move_us'][0]:.3f} / {rec['table']['move_us'][1]:.3f} "
                  f"(table / kTable {mv['table'] / mv['kTable']:.3f}); a launch: kTable "
                  + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in
                              rec["kTable"]["kernels_us"].items())
                  + "; table " + ", ".join(f"{k} {np.mean(v):.3f}" for k, v in
                                           rec["table"]["kernels_us"].items())
                  + f" (on {card})", flush=True)
    path = Path(a.json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, rounds=a.rounds, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
