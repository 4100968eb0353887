"""Share of the traced inference span in which nothing runs on the device."""


def read(layers):
    t = layers.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if layers.kind == "infer" else None
