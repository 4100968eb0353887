"""Late-fusion fixpoint iterations per traced inference batch (the program's counter ``proben.iters``: one host read each); ``None`` where nothing is fused."""


def read(layers):
    iters = layers.counters.get("proben.iters")
    return iters if layers.kind == "infer" and iters else None
