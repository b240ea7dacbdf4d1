"""The readings ``correct``'s limits are set from, for one cell, in one
process on the card:

* the program's readings: a short window at the cell's own load for each
  of ``--seeds``, its outputs compared with the reference (the lower
  readings);
* the control's readings: for each of ``--control-seeds``, the same
  window, with the reference computed in float32 put in the program's
  place (``check.control_outputs``), compared with the float64 reference
  (the upper readings);
* the planted control of ``offspring_copies_pct``, which float32 cannot
  move: for each of ``--parents-seeds``, the window with a variation that
  hands the tournament's parents back unchanged (no crossover, no
  mutation).

    python3 portbench/control.py --workload <cell> --seconds 4 \\
        --seeds <n> ... --control-seeds <n> <n> <n> --parents-seeds <n> <n> <n>

One JSON line per seed, then the largest program reading and the smallest
reading of each control of each number.  The benchmark's own runs never
run it.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.run import prepare_environment  # noqa: E402


def parents_unchanged():
    """Plant the variation fault: crossover and mutation hand their first
    parent back.  Returns the function that removes it."""
    from repro_torch.evo import explorer as ex

    saved = ex.uniform_crossover, ex.mutate
    ex.uniform_crossover = lambda gen, pa, pb, rate: pa
    ex.mutate = lambda gen, genes, bounds, mut_mask=None: genes

    def remove():
        ex.uniform_crossover, ex.mutate = saved
    return remove


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--parents-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    prepare_environment()

    import torch

    from portbench import check
    from portbench.cells import load_cell
    from portbench.drive import build_problem, run_window

    cell = load_cell(args.workload)
    dev = torch.device("cuda")
    problem = build_problem(cell)
    readings = {"program": {}, "control": {}, "parents": {}}
    runs = ([(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds]
            + [(s, "parents") for s in args.parents_seeds])
    with problem.make_engine(sim_backend="cuda", device=dev) as engine:
        for seed, kind in runs:
            remove = parents_unchanged() if kind == "parents" else None
            try:
                window = run_window(cell, problem, engine, seed, args.seconds)
            finally:
                if remove:
                    remove()
            t0 = time.perf_counter()
            outputs = window.outputs
            if kind == "control":
                outputs = check.control_outputs(cell, outputs, seed)
            numbers = check.compare(cell, outputs, seed)
            copies = [round(100.0 * check.copies(g["parents"], g["child"]) / len(g["child"]), 3)
                      for g in window.outputs["generations"]]
            line = dict(seed=seed, kind=kind, numbers=numbers,
                        generations=len(window.in_window) - 1,
                        kept=[g["gen"] for g in window.outputs["generations"]],
                        copies_pct_by_generation=copies,
                        evals_per_s=len(window.gen_seconds()) * int(cell.mix["params"]["offspring"])
                        / max(1e-9, sum(window.gen_seconds())),
                        check_s=time.perf_counter() - t0,
                        correct=all(numbers[k] <= v for k, v in check.LIMITS.items()))
            print(json.dumps(line), flush=True)
            for k, v in numbers.items():
                seen = readings[kind]
                seen[k] = (max if kind == "program" else min)(seen.get(k, v), v)
    print(json.dumps(dict(workload=args.workload, program_max=readings["program"],
                          control_min=readings["control"], parents_min=readings["parents"],
                          device=torch.cuda.get_device_name(dev))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
