"""Kernels launched per inference batch: device kernels in the trace over the traced batches."""


def read(layers):
    return layers.trace.launches / layers.iters if layers.kind == "infer" else None
