"""Share of its roofline that ``proben::roi_align_fwd`` reaches in the traced train iterations: the least time of each call (its operations over the bf16 peak or its bytes over the HBM rate, from that call's inputs) over the device time of the kernels launched under the op."""


def read(layers):
    return layers.roofline_pct("proben::roi_align_fwd") if layers.kind == "train" else None
