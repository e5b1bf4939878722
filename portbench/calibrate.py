"""Readings that the correctness limits of a cell are set from, in one
process on the CUDA card:

    python portbench/calibrate.py --workload cifar10_cond.train_f32_b128 \\
        --seeds 1,2,3 --control-seeds 1,2,3 --fault-seeds 1,2,3 --out readings.jsonl

For each of ``--seeds`` the program's timed path at the cell's own size (one
sampling call, or the checked train steps) against the reference: the lower
readings. For each of ``--control-seeds`` the control, the reference itself
put in the program's place and computed in the precision next below the
cell's (fp8 operands for a bfloat16 cell, TF32 products for a float32 one),
against the reference: the upper readings. For each of ``--fault-seeds`` (train
cells) the program with half of the batch left out, and with each of
``--wrong`` (``key=value`` of the configuration's ``train`` group, for the
program alone: which optimizer faults the limits see). One JSON line per
reading to ``--out`` and to standard output. The runs of the benchmark do
not run any of this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--wrong", action="append", default=[])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.core.jobs import JOBS, free
    from portbench.core.spec import load_cell
    from portbench.reference.precision import fp8

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload, ROOT)
    kind = cell.traffic["job"]
    control, faults = set(_seeds(args.control_seeds)), set(_seeds(args.fault_seeds))
    seeds = list(dict.fromkeys(_seeds(args.seeds) + _seeds(args.control_seeds)
                               + _seeds(args.fault_seeds)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        def emit(**line):
            line.update(workload=args.workload)
            text = json.dumps(line)
            print(text, flush=True)
            out.write(text + "\n")
            out.flush()

        for seed in seeds:
            t0 = time.perf_counter()
            job = JOBS[kind](cell, seed, device)
            job.setup()
            if kind == "sample":
                job.window(float("inf"), max_units=1)
                prog, x_T, y = job.program_rows()
                want = job.reference_rows(x_T, y)
                if seed in _seeds(args.seeds):
                    emit(seed=seed, reading="program", **job.numbers(prog, want))
                if seed in control:
                    emit(seed=seed, reading="control_fp8",
                         **job.numbers(job.reference_rows(x_T, y, quant=fp8), want))
            else:
                got = job.prog
                want = job.reference()
                if seed in _seeds(args.seeds):
                    emit(seed=seed, reading="program", loss=got["loss"], ref_loss=want["loss"],
                         **job.numbers(got, want))
                if seed in control:
                    emit(seed=seed, reading="control_tf32",
                         **job.numbers(job.reference(True), want))
                if seed in faults:
                    del job
                    free(device)
                    broken = JOBS[kind](cell, seed, device, fault="half_batch")
                    broken.setup()
                    emit(seed=seed, reading="fault_half_batch",
                         **broken.numbers(broken.prog, broken.reference()))
                    for wrong in args.wrong:
                        del broken
                        free(device)
                        key, value = wrong.split("=")
                        broken = JOBS[kind](cell, seed, device)
                        kept = cell.config["train"][key]
                        cell.config["train"][key] = float(value)
                        broken.setup()
                        cell.config["train"][key] = kept
                        emit(seed=seed, reading=f"fault_{key}_{value}",
                             **broken.numbers(broken.prog, broken.reference()))
            emit(seed=seed, reading="seconds", value=time.perf_counter() - t0)
            free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
