"""The whole inference step's share of the card's dense bf16 peak: the benchmark's model FLOPs per image times the window's images per second."""

from harness.counts import mfu_pct


def read(layers):
    return mfu_pct(layers.flops_per_image, layers.img_s) if layers.kind == "infer" else None
