"""Share of its roofline that ``proben::stem_pool`` reaches in the traced train iterations: the least time of each call (its operations over the bf16 peak or its bytes over the HBM rate, from that call's inputs) over the device time of the kernels launched under the op."""


def read(layers):
    return layers.roofline_pct("proben::stem_pool") if layers.kind == "train" else None
