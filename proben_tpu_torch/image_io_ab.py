"""A/B timing of the ``image_io`` compose + resize + pad kernel of several
checkouts on one GPU, at the FLIR evaluation shapes: 8 single-channel
512x640 thermal frames resized to 800x1000 in an 800x1024 canvas (BGR),
and the same with 8 1600x1800 RGB frames beside them (BGRTTT).

    python -m proben_tpu_torch.image_io_ab TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); each is timed in
a process of its own, which builds that checkout's kernel, in the order
given (for example parent, change, change, parent). A run is three
readings per format, each the median of 5 groups of 10 back-to-back calls
timed with CUDA events. Prints one line per tree and a JSON object last.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_TIMING = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from proben_tpu_torch import _build
from proben_tpu_torch.native import io
_build.build(["image_io"])
g = torch.Generator(device="cuda").manual_seed(0)
th = [torch.randint(0, 256, (512, 640, 1), generator=g, device="cuda", dtype=torch.uint8)
      for _ in range(8)]
rgb = [torch.randint(0, 256, (1600, 1800, 3), generator=g, device="cuda", dtype=torch.uint8)
       for _ in range(8)]
sizes, pad = [(800, 1000)] * 8, (800, 1024)

def ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return float(np.median(times))

out = {}
for fmt, r in (("BGR", None), ("BGRTTT", rgb)):
    out[fmt] = [ms(lambda: io.compose_resize_pad(th, r, fmt, sizes, pad)) for _ in range(3)]
print(json.dumps(out))
"""


def main(argv=None) -> int:
    trees = list(argv if argv is not None else sys.argv[1:])
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in trees:
        root = os.path.abspath(tree)
        res = subprocess.run([sys.executable, "-c", _TIMING, root], cwd=root, capture_output=True,
                             text=True)
        if res.returncode:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        print(tree, ms, flush=True)
        runs.append({"tree": tree, "ms": ms})
    print(json.dumps({"image_io_ab": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
