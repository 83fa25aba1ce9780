#!/usr/bin/env python3
"""Same-call A/B of the page movers per batch on one NVIDIA GPU, between
two checkouts of the port.

    python3 chip_mover_ab.py [--tree DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout; its
kernels are built there at first use) and times one batch of each
mover at gpt2-xl's main pool: K and V leaves of (48, 49, 16, 25, 32)
in float32, bfloat16 and float8_e4m3fn, W = 4 distinct pages, with
``chip_smoke.Smoke.time_ms`` (device time, input copies rotating
through HBM).  Each batch is timed as the checkout's executor moves it:
one one-leaf launch per leaf (``page_copy`` / ``page_restore``, in
every checkout) and, where the checkout has them, one launch over both
leaves (``page_copy_leaves`` / ``page_restore_leaves``).  The bound
counts each moved row read once and written once at 3.35 TB/s.  To
compare two commits on the same card, unpack the older one with ``git
archive`` into a directory that ``.gitignore`` lists and run, in one
call, older, newer, newer, older.
"""
from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (48, 49, 16, 25, 32)
W = 4


def main(argv) -> int:
    tree, label = ROOT, "this checkout"
    while argv:
        flag, value, argv = argv[0], argv[1:2], argv[2:]
        if flag not in ("--tree", "--label") or not value:
            print("usage: chip_mover_ab.py [--tree DIR] [--label NAME]",
                  file=sys.stderr)
            return 2
        if flag == "--tree":
            tree = Path(value[0]).resolve()
        else:
            label = value[0]
    import torch
    if not torch.cuda.is_available():
        print("chip_mover_ab: no CUDA device", file=sys.stderr)
        return 2
    source = tree / "src" / "repro_torch" / "csrc" / "page_copy.cu"
    if not source.is_file():
        print(f"chip_mover_ab: no {source}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import page_copy as PC
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0]
    _build.lib()
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    print(f"{label}: repro_torch from {tree / 'src'}, page_copy.cu "
          f"sha256 {digest}")
    smoke = chip_smoke.Smoke(torch)
    gen = torch.Generator(device=smoke.dev)
    gen.manual_seed(chip_smoke.SEED + 4)
    src = torch.tensor([3, 17, 40, 8], dtype=torch.int32, device=smoke.dev)
    dst = torch.tensor([21, 5, 33, 47], dtype=torch.int32, device=smoke.dev)
    one_launch = hasattr(PC, "page_copy_leaves")
    for dtype in (torch.float32, torch.bfloat16, torch.float8_e4m3fn):
        size = torch.finfo(dtype).bits // 8
        moved = 2 * 2 * W * size * SHAPE[0] * SHAPE[2] * SHAPE[3] * SHAPE[4]
        n = smoke.copies(moved)
        pools = [[smoke.randn(*SHAPE, gen=gen).to(dtype) for _ in range(2)]
                 for _ in range(n)]
        rows = [[smoke.randn(SHAPE[0], W, *SHAPE[2:], gen=gen).to(dtype)
                 for _ in range(2)] for _ in range(n)]
        ways = {"copy, one launch per leaf": [
            lambda ps=ps: [PC.page_copy(p, src, dst) for p in ps]
            for ps in pools],
            "restore, one launch per leaf": [
            lambda ps=ps, rs=rs: [PC.page_restore(p, r, dst)
                                  for p, r in zip(ps, rs)]
            for ps, rs in zip(pools, rows)]}
        if one_launch:
            ways["copy, one launch"] = [
                lambda ps=ps: PC.page_copy_leaves(ps, src, dst)
                for ps in pools]
            ways["restore, one launch"] = [
                lambda ps=ps, rs=rs: PC.page_restore_leaves(ps, rs, dst)
                for ps, rs in zip(pools, rows)]
        times = {k: smoke.time_ms(fns) for k, fns in ways.items()}
        bound = smoke.bound(moved, 0)[0]
        print(f"ab {label} {str(dtype)[6:]}: per batch of K + V {SHAPE}, "
              f"W={W}: " + ", ".join(f"{k} {v:.4f} ms"
                                     for k, v in times.items())
              + f"; bound {bound:.4f} ms [{card}]")
        del pools, rows
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
