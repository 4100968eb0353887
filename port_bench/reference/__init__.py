"""A plain PyTorch Faster R-CNN R-FPN (detectron2's GeneralizedRCNN with
StandardROIHeads), the benchmark's reference: the detector's forward pass,
its inference and training losses and the SGD update, written from the
published description in float32 with no kernel, no cache and no batching
trick. It imports nothing of the program it judges and takes only what the
benchmark makes: a detectron2-named state dict, frames, ground truth and the
configuration's numbers (``configs/<name>/config.json``).

``precision="fp8"`` rounds every convolution's and linear layer's input and
weight to float8 e4m3 (per-tensor scale, float32 accumulation): the control
that a correct comparison has to reject.
"""
