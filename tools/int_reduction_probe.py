#!/usr/bin/env python3
"""How the int8 / int4 sparse matmul sums its K splits, measured three ways
on one card.

    python3 tools/int_reduction_probe.py [--rounds 1] [--out PATH]

``csrc/sparse_matmul_int8.cu`` splits the reduction over K across thread
blocks.  Each block writes an int32 partial, and ``int_epilogue`` sums the
partials, with 8 lanes per output quad at few quads and one thread per quad
above.  This script builds that source as it stands and three variants of
it, each a substitution of a few lines (``VARIANTS``), and serves every call
through the product's own wrappers:

* ``partials``: the source as it stands;
* ``partials, 8 lanes``: the epilogue with 8 lanes per quad at every M;
* ``partials, 1 lane``: the epilogue with one thread per quad at every M;
* ``atomics``: each block adds its results into one int32 accumulator with
  ``atomicAdd``, zeroed by a ``cudaMemsetAsync`` before the kernel, and the
  epilogue (one thread per quad) reads that one accumulator.

For int8 and int4 at M = 4, 16 and 256 and every (K, N) of a Qwen3-0.6B
layer, each variant must be bit-equal to the plain version.  Per layer it
reports the traced device time (the matmul kernel, the epilogue and the
memset apart), the host's enqueue time and the CUDA-event time with the L2
flushed.  The variants run in the order A B C D D C B A for each round.  It
needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PROBE_M = (4, 16, 256)
SOURCE = "sparse_matmul_int8.cu"

# (old, new) substitutions of the source; each old text occurs exactly once
EIGHT_LANES = [("if (count4 <= FEW_QUADS)", "if (true)")]
ONE_LANE = [("if (count4 <= FEW_QUADS)", "if (false)")]
ATOMICS = ONE_LANE + [
    ("int* part = a.partial + static_cast<size_t>(split) * a.M * np +",
     "int* part = a.partial +"),
    ("*reinterpret_cast<int2*>(p) = make_int2(v0, v1);",
     "atomicAdd(p, v0);\n  atomicAdd(p + 1, v1);"),
    ("  kern<<<dim3(a.Nb, splits), NT, L.bytes, stream>>>(a);",
     "  e = cudaMemsetAsync(a.partial, 0, sizeof(int) * a.M * a.Nb * a.bn,\n"
     "                      stream);\n"
     "  if (e != cudaSuccess) return e;\n"
     "  kern<<<dim3(a.Nb, splits), NT, L.bytes, stream>>>(a);"),
    ("  const int4* p4 = reinterpret_cast<const int4*>(a.partial);",
     "  const int4* p4 = reinterpret_cast<const int4*>(a.partial);\n"
     "  splits = 1;")]
VARIANTS = {"partials": [], "partials, 8 lanes": EIGHT_LANES,
            "partials, 1 lane": ONE_LANE, "atomics": ATOMICS}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"the source no longer holds {old!r} once: "
                             "update VARIANTS")
        text = text.replace(old, new)
    return text


def build_variants(build) -> dict:
    """One shared library per variant, all ``nvcc`` runs started together,
    under the git-ignored build directory."""
    csrc = build.CSRC
    text = (csrc / SOURCE).read_text()
    out_dir = build.BUILD_ROOT.parent / "int_reduction_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = out_dir / f"variant{i}.cu"
        src.write_text(variant_source(text, subs))
        lib = out_dir / f"variant{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc),
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def use_variant(build, lib_path: Path) -> None:
    """Route the wrappers' calls of ``SOURCE`` to one variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build._LIBS[SOURCE] = lib
    for key in [k for k in build._FUNCS if k[0] == SOURCE]:
        del build._FUNCS[key]


def device_parts(torch, fn, n=20) -> dict:
    """Device time per call of ``fn`` from a ``torch.profiler`` trace, by
    part: the matmul kernel, the epilogue, memsets, anything else."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {"matmul": 0.0, "epilogue": 0.0, "memset": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type) or e.self_device_time_total <= 0:
            continue
        key = ("matmul" if "sparse_matmul_int" in e.key else
               "epilogue" if "int_epilogue" in e.key else
               "memset" if "memset" in e.key.lower() else "other")
        parts[key] += e.self_device_time_total / n / 1e3
    return parts


def measure(torch, cs, kernels, cases, timer) -> dict:
    """Per kernel and M: device parts, host enqueue and event time summed
    over the layer's seven linears (ms)."""
    out = {}
    for kname, (fn, plain) in kernels.items():
        for m in PROBE_M:
            tot = {"matmul": 0.0, "epilogue": 0.0, "memset": 0.0,
                   "other": 0.0, "host": 0.0, "event": 0.0}
            for count, args in cases[kname][m]:
                got, ref = fn(*args), plain(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise SystemExit(f"{kname} M={m}: not bit-equal to the "
                                     "plain version")
                for key, val in device_parts(torch,
                                             lambda: fn(*args)).items():
                    tot[key] += count * val
                tot["host"] += count * cs.host_ms_per_call(
                    torch, lambda: fn(*args))
                tot["event"] += count * timer(lambda: fn(*args))
            tot["device"] = sum(tot[k] for k in ("matmul", "epilogue",
                                                 "memset", "other"))
            out[f"{kname} M={m}"] = tot
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the order A B C D D C B A")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe "
                         "needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_act_int8
    from repro_torch.kernels import build
    from repro_torch.kernels.sparse_matmul_int4 import (
        sparse_matmul_int4, sparse_matmul_int4_plain)
    from repro_torch.kernels.sparse_matmul_int8 import (
        sparse_matmul_int8, sparse_matmul_int8_plain)

    card = cs.card_phase(torch, build)
    libs = build_variants(build)
    kernels = {"int8": (sparse_matmul_int8, sparse_matmul_int8_plain),
               "int4": (sparse_matmul_int4, sparse_matmul_int4_plain)}
    linears = cs._layer_linears(get_config("qwen3-0.6b"))
    shapes = sorted({(k, n) for _, k, n in linears})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = {}
    for kname in kernels:
        weights = {kn: cs._packed(torch, *kn, gen, mode=kname)
                   for kn in shapes}
        cases[kname] = {}
        for m in PROBE_M:
            cases[kname][m] = []
            for kn in shapes:
                x = torch.randn((m, kn[0]), generator=gen,
                                device="cuda").to(torch.bfloat16)
                xq, sx = quantize_act_int8(x)
                count = sum(1 for _, k, n in linears if (k, n) == kn)
                cases[kname][m].append(
                    (count, (xq, sx, weights[kn], torch.bfloat16)))
    timer = cs.Timer(torch)
    names = list(VARIANTS)
    order = (names + names[::-1]) * args.rounds
    runs = []
    for name in order:
        use_variant(build, libs[name])
        res = measure(torch, cs, kernels, cases, timer)
        runs.append((name, res))
        for key, t in res.items():
            print(f"[probe] {name}: {key} per layer: device "
                  f"{t['device'] * 1e3:.1f} us (matmul "
                  f"{t['matmul'] * 1e3:.1f}, epilogue "
                  f"{t['epilogue'] * 1e3:.1f}, memset "
                  f"{t['memset'] * 1e3:.1f}, other {t['other'] * 1e3:.1f}),"
                  f" host enqueue {t['host'] * 1e3:.1f} us, event "
                  f"{t['event'] * 1e3:.1f} us [{card}]", flush=True)
    summary = {}
    for name in names:
        for key in runs[0][1]:
            vals = [r[key] for n, r in runs if n == name]
            summary[f"{name}: {key}"] = {
                k: statistics.median(v[k] for v in vals) for k in vals[0]}
            s = summary[f"{name}: {key}"]
            print(f"[probe] median of {len(vals)} runs, {name}: {key} per "
                  f"layer: device {s['device'] * 1e3:.1f} us (matmul "
                  f"{s['matmul'] * 1e3:.1f}, epilogue "
                  f"{s['epilogue'] * 1e3:.1f}, memset "
                  f"{s['memset'] * 1e3:.1f}), host enqueue "
                  f"{s['host'] * 1e3:.1f} us, event {s['event'] * 1e3:.1f} "
                  f"us [{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
