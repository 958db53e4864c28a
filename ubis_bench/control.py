"""The control: the plain reference in the program's place, in TF32.

The configurations state fp32 scores with TF32 off.  The control answers
every search of a cell's traffic by an exact scan of the live set whose
products take TF32's inputs (10-bit mantissas, rounded to nearest, as
the tensor cores round them; fp32 sums), the step below fp32 that would
tempt a later change.  The benchmark's runs never use it: this script
reads its numbers on the chip at a cell's own size, and
``tests/test_ubis_bench_control.py`` holds it at a small size, to show
that ``correct`` comes out false for it.

    python3 ubis_bench/control.py --workload float-query --seconds 5 --seeds 1 2 3

With ``--index drop-inserts`` it reads instead the program with
:func:`faults.drop_inserts` planted (5% of each window insert lost).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "ubis_bench":
    del sys.path[0]
for p in (ROOT / "src", ROOT):       # the program, for the planted fault
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BLOCK_FLOATS = 1 << 28


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Tf32Index:
    """An exact index whose scores ``||v||^2 - 2 q.v`` take the product in
    TF32: the protocol the harness drives (insert, delete, tick,
    dispatch_search, collect_search), nothing of the program."""

    def __init__(self, config: dict, seed_vectors, device, seed: int):
        ix = config["index"]
        self.dev = torch.device(device)
        self.vecs = torch.zeros(ix["max_ids"], ix["dim"], device=self.dev)
        self.norm = torch.zeros(ix["max_ids"], device=self.dev)
        self.live = torch.zeros(ix["max_ids"], dtype=torch.bool,
                                device=self.dev)
        self.stats = {}

    def insert(self, vecs, ids):
        v = torch.as_tensor(np.asarray(vecs, np.float32), device=self.dev)
        i = torch.as_tensor(np.asarray(ids, np.int64), device=self.dev)
        self.vecs[i] = tf32(v)
        self.norm[i] = (v * v).sum(1)
        self.live[i] = True
        return types.SimpleNamespace(accepted=len(ids), cached=0, rejected=0)

    def delete(self, ids):
        self.live[torch.as_tensor(np.asarray(ids, np.int64),
                                  device=self.dev)] = False
        return types.SimpleNamespace(deleted=len(ids), blocked=0)

    def tick(self):
        return types.SimpleNamespace(executed=0, marked=0, spilled=0,
                                     promoted=0)

    def dispatch_search(self, queries, k: int):
        q = tf32(torch.as_tensor(np.asarray(queries, np.float32),
                                 device=self.dev))
        rows = self.live.nonzero()[:, 0]
        v, vn = self.vecs[rows], self.norm[rows]
        block = max(1, BLOCK_FLOATS // max(1, rows.numel()))
        ids, scores = [], []
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # rounded inputs
        try:
            for off in range(0, q.shape[0], block):
                s = torch.addmm(vn[None], q[off:off + block], v.T,
                                alpha=-2.0)
                top, pos = torch.topk(s, k, dim=1, largest=False)
                ids.append(rows[pos])
                scores.append(top)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return (torch.cat(ids), torch.cat(scores))

    def collect_search(self, handle):
        ids, scores = handle
        return types.SimpleNamespace(ids=ids.to(torch.int32).cpu().numpy(),
                                     scores=scores.cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--index", choices=("tf32", "drop-inserts"),
                    default="tf32")
    args = ap.parse_args(argv)
    from ubis_bench import faults, harness
    factory = {"tf32": Tf32Index,
               "drop-inserts": faults.drop_inserts}[args.index]
    if not torch.cuda.is_available():
        harness.say("no CUDA device")
        return 3
    spec = harness.load_spec(ROOT, args.workload, False)
    for seed in args.seeds:
        t = time.perf_counter()
        line = harness.run_cell(spec, seed=seed, seconds=args.seconds,
                                trace=False, device="cuda", t_start=t,
                                index_factory=factory)
        print(json.dumps({"control": args.index, "workload": args.workload,
                          "seed": seed, "correct": line["correct"],
                          "batches": line["window"]["batches"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
