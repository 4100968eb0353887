"""Whether ``correct`` sees a ProbEn cell's fusion (run on the GPU, from the
root of a checkout; prints JSON lines).

    python3 port_bench/proben_faults.py --workload flir_proben_late.infer_b16 --seeds 1 2 ...

Per seed, as ``calibrate.py`` reads the program: the members' detections an
image over the pool, the union and the fused answer; over the sampled
images the reference fusion's clusters of several members; and the numbers
that decide ``correct`` for the program and for the program with each
planted fusion fault (``probEn`` scores replaced by ``avg``, ``v-avg``
boxes by ``avg``), against the same reference answer.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAULTS = {"fault_probEn_to_avg": {"score_method": "avg"}, "fault_v_avg_to_avg": {"box_method": "avg"}}


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def spread(values) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def readings(workload: str, seeds, device, root: Path = ROOT) -> None:
    from harness import cells, frames, judge
    from proben_tpu_torch.engine.ensemble import ProbEnPredictor

    cell = cells.Cell(root, workload)
    arch, tf, conf = cell.arch, cell.traffic, cell.conf
    pcfg = arch.read_config(str(cell.config_file.parent), conf)
    for seed in seeds:
        t = time.perf_counter()
        pool = frames.inference_pool(seed, tf, conf["input"], cell.channels, device)
        state = cells.make_weights(cell, seed, pool[0], device)
        pred = arch.predictor(pcfg, state, device)
        counts = [[] for _ in pred.members]
        for b in pool:
            for k, d in enumerate(pred.member_detections(b["image"], b["image_size"], b["orig_size"])):
                counts[k] += d.valid.sum(1).tolist()
        served = [pred.predict_batch(b) for b in pool]
        fusion = {"score_method": pred.score_method, "box_method": pred.box_method, "thresh": pred.thresh,
                  "class_offset": pred.class_offset, "topk": pred.topk}
        faulty = {kind: [ProbEnPredictor(pred.members, **dict(fusion, **fault)).predict_batch(b) for b in pool]
                  for kind, fault in FAULTS.items()}
        del pred
        cells.free(device)
        emit(kind="members", workload=workload, seed=seed, per_member=[spread(c) for c in counts],
             union=spread([sum(c) for c in zip(*counts)]),
             fused=spread([len(d["scores"]) for out in served for d in out]))
        picks = cells.pick_images(seed, served, tf["check_images"])
        imgs = [pool[b]["image"][r] for b, r in picks]
        want = arch.reference_detections(conf, state, imgs, device)
        sizes = [w["size"] for w in want]
        emit(kind="clusters", workload=workload, seed=seed,
             multi_per_image=spread([int((s > 1).sum()) for s in sizes]),
             multi_share_pct=100.0 * sum(int((s > 1).sum()) for s in sizes) / max(sum(len(s) for s in sizes), 1),
             mean_multi_size=statistics.fmean([int(x) for s in sizes for x in s if x > 1] or [0]))
        emit(kind="program", workload=workload, seed=seed,
             **judge.detection_numbers([served[b][r] for b, r in picks], want))
        for kind, out in faulty.items():
            emit(kind=kind, workload=workload, seed=seed, **judge.detection_numbers([out[b][r] for b, r in picks], want))
        emit(kind="seconds", workload=workload, seed=seed, seconds=time.perf_counter() - t)
        del state
        cells.free(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    readings(args.workload, args.seeds, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
