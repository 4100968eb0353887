"""Kernels launched per training step: device kernels in the trace over the traced steps."""


def read(layers):
    return layers.trace.launches / layers.iters if layers.kind == "train" else None
