"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix and
metrics are found by name through ``BENCHMARK.json`` (see
``portbench/cells.py``).  With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics, the device's busy seconds and a breakdown.  Each
number the correctness check compares is printed beside its limit, as the
last lines of standard error and as the result's last key.

Fails, printing no result, without a CUDA card (or with fewer than the
cell asks for), where the program (``src/repro_torch``) is absent, and
when a module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded
once the window has closed.  Build and kernel caches stay inside the
checkout at fixed paths under ``build/``.  The process keeps to one host
thread (``OMP_NUM_THREADS`` and its kin, ``torch.set_num_threads``): the
explorer's loop is one Python thread, and no thread pool beside it takes
the shared host's cores.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_environment(root: str = ROOT) -> None:
    """Fixed cache directories inside the checkout; the program and the
    harness on the import path."""
    build = os.path.join(root, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "portbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "portbench", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_OBS", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for p in (root, os.path.join(root, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    the port may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()

    from portbench.cells import load_cell

    cell = load_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here where the program is absent)

    from portbench.bench import run

    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
