"""Run one cell of the benchmark once and print its result line.

    python3 ubis_bench/run.py --workload float-query --seed 7 --seconds 20 --trace 0

(or ``PYTHONPATH=src python -m ubis_bench.run ...``) from the root of a
checkout.  It needs as many CUDA cards as the cell asks for, and exits
non-zero without a result line otherwise.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number the reference compared, with its limit.
The same numbers close standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "ubis_bench":
    del sys.path[0]          # run as a script: no sibling module shadows
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# caches inside the checkout, at fixed paths (the port's own kernels are
# built into src/repro_torch/_build/<hash>/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "_bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "_bench_cache" /
                                         "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from ubis_bench import harness

    spec = harness.load_spec(ROOT, args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        harness.say("no CUDA device: this benchmark measures the card")
        return 3
    if torch.cuda.device_count() < spec.chips:
        harness.say(f"{args.workload} needs {spec.chips} cards, this "
                    f"machine has {torch.cuda.device_count()}")
        return 3
    line = harness.run_cell(spec, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), device="cuda",
                            t_start=T_START)
    # last, once every module the run loads (the reference's, each
    # metric's reader) is loaded: no JAX, no JAX package
    loaded = harness.forbidden_modules()
    if loaded:
        harness.say(f"refused: the process holds {loaded} after the window")
        return 4
    for text in harness.check_lines(line):
        harness.say(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
