"""Host calls that wait for the device (stream, device and event syncs, blocking copies) per inference batch."""


def read(layers):
    return layers.trace.blocking_calls / layers.iters if layers.kind == "infer" else None
