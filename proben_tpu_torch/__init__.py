"""PyTorch + CUDA port of ``proben_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``proben_tpu``'s layout and names so each module has an
obvious counterpart there; ``proben_tpu`` stays the numerical reference. It
imports torch, numpy and the standard library only (cv2 only in the CPU
branches of ``data`` and ``apps.kaist`` that read images as the JAX package
does).

It covers Faster R-CNN R50/R101-FPN inference and training in every fusion
mode of the JAX package: single-modality (BGR), BGRT early fusion (one
backbone with a 4-channel stem), BGRTTT middle fusion (two backbones, the
per-level maps concatenated) and ProbEn late fusion of several detectors'
outputs (``fusion``), the FLIR and KAIST evaluation entry points around
the model (``apps.flir``, ``apps.kaist``: config, data, JPEG loading on the
card, COCO mAP and LAMR) and checkpoints (``checkpoint``: detectron2
``.pth``/``.pkl`` import, ``torch.save`` checkpoints and their manager). Its
hand-written Hopper kernels live under ``csrc/`` and are built with ``nvcc``
at first use (``_build.py``):

  * ``csrc/stem.cu``            fused 7x7/s2 conv + affine + ReLU + 3x3/s2 max-pool
  * ``csrc/roi_align_fwd.cu``   windowed multi-level RoIAlignV2 forward
  * ``csrc/roi_align_bwd.cu``   its backward with respect to the feature maps
  * ``csrc/image_io.cu``        nvJPEG decode and the compose + resize + pad kernel
  * ``csrc/block_epilogue.cu``  a bottleneck conv's affine + residual + ReLU, and its backward

Entry points (``models.build_model``, ``engine.Predictor``, the data mapper
and the apps) default to ``device="cuda"`` and raise when no GPU is
present; pass ``device="cpu"`` to run the kernels' plain PyTorch versions
instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
