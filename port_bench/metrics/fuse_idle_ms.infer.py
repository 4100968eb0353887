"""Device idle inside the late fusion (the program's span ``proben.fuse``: ``fuse_detections_torch``, its fixpoint's host reads included) per traced inference batch, in ms; ``None`` where nothing is fused."""


def read(layers):
    if layers.kind != "infer" or not layers.spans.calls("proben.fuse"):
        return None
    return 1e3 * layers.spans.span_idle_seconds("proben.fuse") / layers.iters
