#!/usr/bin/env python3
"""Where the sparse gemv's time goes, and its rows per split, from traces
on one card.

    python3 tools/gemv_probe.py [--out PATH]

1. **rows per split**: for each choice (64 everywhere, 32 everywhere, and
   32 only where 64 would launch fewer than 256 blocks), the gemv is held
   at the seven Qwen3-0.6B linears against its plain version at M = 1, 4
   and 8 (bf16 x and values, seeded random weights at 50% sparsity) and
   each linear's device time per call is read from a ``torch.profiler``
   trace (the one launch, its merge included).
2. **variants**: ``csrc/sparse_gemv.cu`` as it stands and variants of it,
   each a substitution of a few lines (``VARIANTS``), built side by side
   and served through the product's own wrapper at rows per split 64:
   the source; no merge (each block
   returns after writing its partial: no fence, ticket or merge); no
   expansion (each weight read as 1, no rank and no value read); staging
   only (no expansion loop and no merge); and an empty kernel (the launch
   alone).  Variants that keep the arithmetic must stay within the
   tolerance of the plain version; the others are timed only.

Prints one line per (choice or variant, M) with the layer's sum and each
linear's time.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
M_VALUES = (1, 4, 8)
SOURCE = "sparse_gemv.cu"

_LOOP = "    for (int q = g * per; q < q1; ++q) {"
_NO_MERGE = ("  // 5. the ticket: the last of the column block's splits "
             "merges them\n  __threadfence();",
             "  if (a.M > 0) return;\n  __threadfence();")
# (old, new) substitutions of the source, each old text held exactly once,
# and whether the variant still computes the product
VARIANTS = {
    "source": ([], True),
    "no merge": ([_NO_MERGE], False),
    "no expansion": ([(
        "        v[j] = set ? to_f32(s_v[min(r, a.cap - 1) - lo_a]) : 0.f;",
        "        v[j] = 1.f;")], False),
    "staging only": ([(_LOOP, "    for (int q = q1; q < q1; ++q) {"),
                      _NO_MERGE], False),
    "empty": ([("  const int t = threadIdx.x;\n  const int nb = blockIdx.x",
                "  if (a.M > 0) return;\n  const int t = threadIdx.x;\n"
                "  const int nb = blockIdx.x")], False),
}


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
    text = (build.CSRC / SOURCE).read_text()
    out_dir = build.BUILD_ROOT.parent / "gemv_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        src = out_dir / f"variant{i}.cu"
        src.write_text(variant_source(text, subs))
        lib = out_dir / f"variant{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
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
    """Route the wrapper's calls of ``SOURCE`` to one variant's library."""
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build._LIBS[SOURCE] = lib
    for key in [k for k in build._FUNCS if k[0] == SOURCE]:
        del build._FUNCS[key]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE / "src"), str(HERE)]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this probe "
                         "needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sparse_gemv as gv
    card = cs.card_phase(torch, build)
    cs.build_phase(build)
    libs = build_variants(build)
    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    linears = cs._layer_linears(cfg)
    weights = {(k, n): cs._packed(torch, k, n, gen) for _, k, n in linears}
    xs = {k: torch.randn((max(M_VALUES), k), generator=gen,
                         device="cuda").to(torch.bfloat16)
          for _, k, _ in linears}
    plan = gv.gemv_plan.__wrapped__

    def fixed(rps):
        def choose(k, n, block, *a):
            gv.ROWS_PER_SPLIT = rps
            return plan(k, n, block, *a)
        return choose

    def adaptive(k, n, block, *a):
        bk, bn = block
        gv.ROWS_PER_SPLIT = 64
        if -(-n // bn) * -(-k // bk) * -(-bk // 64) < 256:
            gv.ROWS_PER_SPLIT = 32
        return plan(k, n, block, *a)

    def layer(name, m, choose, exact):
        row = {"layer_device_us": 0.0, "linears": {}}
        for lin, k, n in linears:
            sw, x = weights[(k, n)], xs[k][:m]
            got = gv.sparse_gemv(x, sw)
            ref = gv.sparse_gemv_plain(x, sw)
            torch.cuda.synchronize()
            tol = 2.0 ** -7 * ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            if exact and not err <= tol:
                raise SystemExit(f"{name} {lin} M={m}: err {err:.3e} > "
                                 f"{tol:.3e}")
            dev = cs.device_ms_per_call(torch, lambda: gv.sparse_gemv(x, sw),
                                        n=50)
            if not isinstance(dev, float):
                raise SystemExit(f"{name} {lin}: {dev}")
            row["linears"][lin] = {"device_us": dev * 1e3,
                                   "blocks": choose(k, n,
                                                    tuple(sw.block)).blocks}
            row["layer_device_us"] += dev * 1e3
        cs.say(f"gemv probe {name}, M={m}: layer "
               f"{row['layer_device_us']:.2f} us traced device; " +
               ", ".join(f"{lin} {v['device_us']:.2f} us ({v['blocks']} "
                         f"blocks)" for lin, v in row["linears"].items()))
        return row

    saved = gv.gemv_plan, gv.ROWS_PER_SPLIT
    res = {"card": card}
    try:
        for name, choose in (("rps 64", fixed(64)), ("rps 32", fixed(32)),
                             ("rps 32 below 256 blocks", adaptive)):
            gv.gemv_plan = choose
            for m in M_VALUES:
                res[f"{name}, M={m}"] = layer(name, m, choose, True)
        gv.gemv_plan = fixed(64)
        for name, (_, exact) in VARIANTS.items():
            use_variant(build, libs[name])
            for m in M_VALUES:
                res[f"variant {name}, M={m}"] = layer(f"variant {name}", m,
                                                      fixed(64), exact)
    finally:
        gv.gemv_plan, gv.ROWS_PER_SPLIT = saved
        build._LIBS.pop(SOURCE, None)
        for key in [k for k in build._FUNCS if k[0] == SOURCE]:
            del build._FUNCS[key]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
