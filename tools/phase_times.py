"""Run a checkout's ``chip_smoke.py`` with its phases and its measurement
helpers timed: the seconds of each call of each function named in
``TIMED`` (a phase's time holds its helpers' time), summed by name, and
the whole run's.

Usage, from the root of a checkout, on the card:
  python3 tools/phase_times.py [CHECKOUT] [--out FILE] [-- ARGS...]

CHECKOUT (default: this checkout) holds the ``chip_smoke.py`` to run, with
its own ``src/``; ARGS go to its ``main``.  The script runs as it would
alone (its spawned ranks import it by its module name, so CHECKOUT goes
on ``sys.path``); the times go to standard error and, with ``--out``, to
FILE as JSON.  Functions a checkout lacks are skipped, so one call times
two checkouts alike (``git archive <commit> | tar -x -C build/parent``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

# the phases of chip_smoke.py's main run, and the helpers that only measure
TIMED = (
    "card_phase", "build_phase", "kernel_phase", "serve_phase", "spec_phase",
    "two_pass_phase", "spec_identity_f32", "oneshot_phase", "paged_phase",
    "identity_phase", "spec_paged_phase", "server_phase", "snapshot_phase",
    "checkify_phase", "wide_phases", "wide_kernels", "wide_serve_phase",
    "vlm_phase", "moe_phase", "rwkv_phase", "seamless_phase", "jamba_phase",
    "jamba_mamba_phase", "train_phase", "mesh_phase", "train_mesh_phase",
    # measurement helpers
    "_profiled", "device_ms_per_call", "train_profile", "overlap_run",
    "unchunked_captures", "train_kernel_rows", "mesh_kernel_rows",
    "dense_rows")


def main() -> int:
    argv = sys.argv[1:]
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.checkout).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    times = {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                row = times.setdefault(name, {"seconds": 0.0, "calls": 0})
                row["seconds"] += time.perf_counter() - t0
                row["calls"] += 1
        return call
    wrapped = {}
    for name in TIMED:
        fn = getattr(mod, name, None)
        if callable(fn):
            wrapped[fn] = timed(name, fn)
            setattr(mod, name, wrapped[fn])
    # phase tables hold the functions themselves
    for key, val in list(vars(mod).items()):
        if isinstance(val, tuple) and any(
                isinstance(v, tuple) and len(v) == 2 and v[1] in wrapped
                for v in val):
            setattr(mod, key, tuple(
                (v[0], wrapped[v[1]]) if isinstance(v, tuple) and len(v) == 2
                and v[1] in wrapped else v for v in val))
    sys.argv = [str(root / "chip_smoke.py"), *rest]
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = mod.main()
    finally:
        out = {"checkout": str(root), "args": rest, "rc": rc,
               "total_s": time.perf_counter() - t0, "functions": times}
        print(json.dumps(out, indent=1), file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
