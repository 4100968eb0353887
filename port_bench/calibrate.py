"""How the benchmark's fixed numbers were found (run on the GPU, from the
root of a checkout; prints JSON lines).

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 ... [--faults N]
        The numbers that decide ``correct`` on each seed for the program, for
        the control (the reference in float8 in the program's place) and for
        planted faults (on the first N seeds), at the cell's own sizes: the
        readings the limits in ``limits/<cell>.json`` are set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _dets(items):
    return [{k: np.asarray(d[k]).tolist() for k in ("boxes", "scores", "classes")} for d in items]


def readings(workload: str, seeds, device, faults: int, root: Path = ROOT, dump: Path = None) -> None:
    """Per seed: the program's numbers as a run would judge them; on the
    first ``faults`` seeds also the control's and each planted fault's."""
    from harness import cells, frames, judge

    cell = cells.Cell(root, workload)
    arch, tf, conf = cell.arch, cell.traffic, cell.conf
    pcfg = arch.read_config(str(cell.config_file.parent), conf)
    for n_seed, seed in enumerate(seeds):
        t = time.perf_counter()
        more = n_seed < faults
        if tf["loop"] == "predict_batch":
            pool = frames.inference_pool(seed, tf, conf["input"], cell.channels, device)
            state = cells.make_weights(cell, seed, pool[0], device)
            pred = arch.predictor(pcfg, state, device)
            served = [pred.predict_batch(b) for b in pool]
            del pred
            cells.free(device)
            picks = cells.pick_images(seed, served, tf["check_images"])
            imgs = [pool[b]["image"][r] for b, r in picks]
            got = [served[b][r] for b, r in picks]
            want = arch.reference_detections(conf, state, imgs, device)
            emit(kind="program", workload=workload, seed=seed, **judge.detection_numbers(got, want))
            if more:
                ctrl = arch.reference_detections(conf, state, imgs, device, precision="fp8")
                emit(kind="control_fp8", workload=workload, seed=seed, **judge.detection_numbers(ctrl, want))
            if dump is not None:
                dump.mkdir(parents=True, exist_ok=True)
                (dump / f"{workload}.{seed}.json").write_text(json.dumps(
                    {"served": _dets(got), "reference": _dets(want), "control": _dets(ctrl) if more else None}))
                half = [g if i < len(got) // 2 else {k: g[k][:0] for k in ("boxes", "scores", "classes")}
                        for i, g in enumerate(got)]
                emit(kind="fault_half_batch", workload=workload, seed=seed, **judge.detection_numbers(half, want))
                swapped = [got[1]] + got[1:]  # one image's answer replaced by another's
                emit(kind="fault_answer_altered", workload=workload, seed=seed,
                     **judge.detection_numbers(swapped, want))
        else:
            pool = frames.training_pool(seed, tf, conf["input"], cell.channels, device)
            state = cells.make_weights(cell, seed, pool[0], device)
            trainer = arch.trainer(pcfg, state, seed, device)
            batches = [trainer.batch(b) for b in pool]
            before = {n: p.detach().clone() for n, p in trainer.params().items()}
            prog = {"losses": []}
            for i in range(tf["checked_steps"]):
                m = trainer.step(batches[i])
                prog["losses"].append({k: float(v) for k, v in m.items()})
                if i == 0:
                    prog["grad"] = cells.norms(trainer.momentum())
            prog["update"] = cells.norms({n: p.detach() - before[n] for n, p in trainer.params().items()})
            del trainer, batches, before
            cells.free(device)
            want = arch.reference_steps(conf, state, pool, seed, tf["checked_steps"], device)
            emit(kind="program", workload=workload, seed=seed,
                 losses=[x["total_loss"] for x in prog["losses"]],
                 ref_losses=[x["total_loss"] for x in want["losses"]], **judge.training_numbers(prog, want))
            if more:
                ctrl = arch.reference_steps(conf, state, pool, seed, tf["checked_steps"], device, precision="fp8")
                emit(kind="control_fp8", workload=workload, seed=seed, **judge.training_numbers(ctrl, want))
                half = arch.reference_steps(conf, state, pool, seed, tf["checked_steps"], device,
                                            batch_filter=lambda n: list(range(n // 2)))
                emit(kind="fault_half_batch", workload=workload, seed=seed, **judge.training_numbers(half, want))
        emit(kind="seconds", workload=workload, seed=seed, seconds=time.perf_counter() - t)
        del state
        cells.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3, help="seeds (the first) with the control and faults")
    ap.add_argument("--dump", type=Path, help="a directory for the detections compared (inference)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    readings(args.workload, args.seeds, "cuda", args.faults, dump=args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
