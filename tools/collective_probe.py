"""Time the training mesh's host-staged collectives on the card: 4 gloo
ranks sharing it (as ``chip_smoke.py``'s mesh phases run them), each
``all_reduce`` and ``all_gather`` of ``distributed/sharding.py`` at a
gradient leaf's size and at a tensor-parallel activation's, split into
the device-to-host copy, gloo's own call and the copy back; and gloo's
``reduce_scatter_tensor`` where this torch has it.

Usage, from the root of a checkout, on the card:
  python3 tools/collective_probe.py [--mb 600 8] [--reps 3]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rank_body(rank, world, sizes_mb, reps):
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import all_gather, all_reduce
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",), torch.cuda.current_device())
    out = {"torch": torch.__version__}
    for mb in sizes_mb:
        n = int(mb * 2 ** 20 // 4)
        x = torch.ones(n, device="cuda")
        host = torch.empty(n, pin_memory=True)
        row = {}
        for name, fn in (
                ("d2h", lambda: host.copy_(x)),
                ("gloo_all_reduce", lambda: dist.all_reduce(
                    host, group=mesh.group("data"))),
                ("h2d", lambda: x.copy_(host)),
                ("staged_all_reduce", lambda: all_reduce(x, mesh, "data")),
                ("staged_all_gather", lambda: all_gather(
                    x[:n // world], mesh, "data"))):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[name] = statistics.median(times)
        try:
            chunk = torch.empty(n // world)
            times = []
            for _ in range(reps):
                dist.barrier()
                t0 = time.perf_counter()
                dist.reduce_scatter_tensor(chunk, host[:n // world * world],
                                           group=mesh.group("data"))
                times.append(time.perf_counter() - t0)
            row["gloo_reduce_scatter"] = statistics.median(times)
        except Exception as e:              # report what this torch lacks
            row["gloo_reduce_scatter"] = f"{type(e).__name__}: {e}"[:120]
        out[f"{mb} MB"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=float, nargs="+", default=[600.0, 8.0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import subprocess
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.launch.mesh import spawn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    recs = spawn(rank_body, 4, (args.mb, args.reps), backend="gloo",
                 device="cuda", timeout=600)
    print(json.dumps({"card": card, "ranks": recs}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
