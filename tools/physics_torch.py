"""Run the physics validation scripts of ``tests/`` against the PyTorch port.

    python3 tools/physics_torch.py [--device cuda|cpu] [--full] [--json PATH] NAME ...
    python3 tools/physics_torch.py --device cpu --which

Each NAME is a script of ``tests/`` and, after a colon, the case its
``--only`` takes: ``binder_crossings[:square|triangular|cubic|bcc|fcc]``,
``spin_glass_crossings[:houdayer|cmr|jorg|cmr_houd4]``,
``autocorrelation_scaling``, ``overlap_histogram``; ``all`` names every
script, the spin-glass script once for each of its moves.

The scripts import ``peapods_tpu`` (the JAX package).  This runner puts a
module of that name into ``sys.modules`` first: its ``Ising`` is the port's
(``peapods_tpu_torch.models.ising.Ising``) on ``--device`` (default
``cuda``), its ``sweep._cumulative_overlap_ratio`` the port's copy.  No file
of the JAX package is imported and the scripts are run as they are: each
script's ``run(quick=True)`` (``--full``: ``quick=False``), its own
assertions deciding its outcome.  Prints each script's output, then its
outcome and seconds, and exits non-zero if any failed.

``--which`` prints what ``from peapods_tpu import Ising`` resolves to, and
runs no script.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
SCRIPTS = ("binder_crossings", "spin_glass_crossings", "autocorrelation_scaling",
           "overlap_histogram")
ALL = ("binder_crossings", "spin_glass_crossings:houdayer", "spin_glass_crossings:cmr",
       "spin_glass_crossings:jorg", "spin_glass_crossings:cmr_houd4",
       "autocorrelation_scaling", "overlap_histogram")


def install(device: str) -> types.ModuleType:
    """Register ``peapods_tpu`` and ``peapods_tpu.sweep`` as the port's."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from peapods_tpu_torch.models.ising import Ising as PortIsing
    from peapods_tpu_torch.sweep import _cumulative_overlap_ratio

    class Ising(PortIsing):
        """The port's ``Ising`` on the runner's device."""

        def __init__(self, *args, device=device, **kwargs):
            super().__init__(*args, device=device, **kwargs)

    pkg = types.ModuleType("peapods_tpu")
    pkg.__path__ = []  # a package: its submodules come from sys.modules
    pkg.Ising = Ising
    sweep = types.ModuleType("peapods_tpu.sweep")
    sweep._cumulative_overlap_ratio = _cumulative_overlap_ratio
    pkg.sweep = sweep
    sys.modules["peapods_tpu"] = pkg
    sys.modules["peapods_tpu.sweep"] = sweep
    return pkg


def load(script: str):
    """Import ``tests/<script>.py`` under a name of its own."""
    if script not in SCRIPTS:
        raise SystemExit(f"unknown script {script!r}: choose from {', '.join(SCRIPTS)}")
    spec = importlib.util.spec_from_file_location(f"physics_{script}",
                                                  TESTS / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(name: str, quick: bool = True) -> float:
    """Run one NAME (``script[:case]``); returns its seconds.  The script's
    own assertions raise."""
    script, _, case = name.partition(":")
    mod = load(script)
    t0 = time.perf_counter()
    if case:
        mod.run(quick=quick, only=case)
    else:
        mod.run(quick=quick)
    return time.perf_counter() - t0


def which(device: str) -> dict:
    install(device)
    from peapods_tpu import Ising  # the registered module's
    from peapods_tpu.sweep import _cumulative_overlap_ratio

    base = Ising.__mro__[1]
    ref_dir = str(ROOT / "peapods_tpu") + "/"
    return {
        "Ising": f"{base.__module__}.{base.__qualname__}",
        "device": Ising.__init__.__kwdefaults__["device"],
        "cumulative_overlap_ratio": _cumulative_overlap_ratio.__module__,
        "jax_imported": "jax" in sys.modules,
        "reference_imported": any(
            str(getattr(m, "__file__", None) or "").startswith(ref_dir)
            for m in list(sys.modules.values())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="script[:case] ..., or all")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="run(quick=False)")
    ap.add_argument("--json", default=None, help="write the outcomes here")
    ap.add_argument("--which", action="store_true")
    args = ap.parse_args(argv)
    if args.which:
        print(json.dumps(which(args.device)), flush=True)
        return 0
    names = [x for n in args.names for x in (ALL if n == "all" else (n,))]
    if not names:
        ap.error("name a script, or all")
    install(args.device)
    outcomes = []
    for name in names:
        t0 = time.perf_counter()
        try:
            seconds = run_one(name, quick=not args.full)
            outcome = "passed"
        except Exception as exc:  # the script's failure is its outcome
            traceback.print_exc()
            seconds = time.perf_counter() - t0
            outcome = f"failed: {type(exc).__name__}: {exc}"
        outcomes.append({"name": name, "outcome": outcome, "seconds": seconds})
        print(f"physics_torch: {name}: {outcome} in {seconds:.1f} s on {args.device}",
              flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(outcomes, indent=1))
    print(json.dumps(outcomes), flush=True)
    return 0 if all(o["outcome"] == "passed" for o in outcomes) else 1


if __name__ == "__main__":
    sys.exit(main())
