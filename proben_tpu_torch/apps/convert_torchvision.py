"""Convert a torchvision ResNet checkpoint to detectron2's names
(counterpart of ``tools/convert_torchvision.py``; reference
``tools/convert-torchvision-to-d2.py``): a ``.pkl`` that
``checkpoint.import_detectron2_checkpoint`` (or detectron2) loads.

    python -m proben_tpu_torch.apps.convert_torchvision r50.pth r50.pkl [--device cpu]

Then point a config at it:

    MODEL:
      WEIGHTS: "/path/to/r50.pkl"
      PIXEL_MEAN: [123.675, 116.280, 103.530]
      PIXEL_STD: [58.395, 57.120, 57.375]
      RESNETS: {DEPTH: 50, STRIDE_IN_1X1: False}
    INPUT: {FORMAT: "RGB"}

The tensors are loaded onto ``--device`` (default ``cuda``, as every
entry point of the port; ``cpu`` keeps them on the host) and written from
the host; the file is the same either way.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Optional, Sequence

import torch

from ..device import resolve_device


def torchvision_key_to_d2(k: str) -> str:
    """torchvision ResNet state-dict key -> detectron2 backbone key (the
    reference script's rename table)."""
    if "layer" not in k:
        k = "stem." + k
    for t in (1, 2, 3, 4):
        k = k.replace(f"layer{t}", f"res{t + 1}")
    for t in (1, 2, 3):
        k = k.replace(f"bn{t}", f"conv{t}.norm")
    k = k.replace("downsample.0", "shortcut")
    k = k.replace("downsample.1", "shortcut.norm")
    return k


def convert(src: str, dst: str, device="cuda") -> None:
    """Read the torchvision ``.pth`` ``src`` (a state dict, or a dict with
    "state_dict") onto ``device`` and write detectron2's ``.pkl`` to
    ``dst``; the classifier's ``fc.*`` keys are left out."""
    obj = torch.load(src, map_location=resolve_device(device))
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    model = {}
    unconverted = []
    for old_k in list(obj.keys()):
        if old_k.startswith("fc."):
            unconverted.append(old_k)  # the classifier head: no backbone key
            continue
        new_k = torchvision_key_to_d2(old_k)
        print(old_k, "->", new_k)
        model[new_k] = obj[old_k].detach().cpu().numpy()
    res = {"model": model, "__author__": "torchvision", "matching_heuristics": True}
    with open(dst, "wb") as f:
        pickle.dump(res, f)
    if unconverted:
        print("Unconverted keys:", unconverted)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m proben_tpu_torch.apps.convert_torchvision")
    parser.add_argument("src", help="torchvision ResNet .pth")
    parser.add_argument("dst", help="detectron2 .pkl to write")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    convert(args.src, args.dst, args.device)


if __name__ == "__main__":
    main()
