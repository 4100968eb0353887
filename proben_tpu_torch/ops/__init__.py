"""Tensor ops; ``stem_cuda`` and ``roi_align_cuda`` hold the CUDA kernels'
wrappers and their plain versions. Importing ``stem_cuda``,
``roi_align_cuda`` and ``nms`` registers the ``torch.library`` custom ops
``proben::stem_pool``, ``proben::roi_align_fwd``, ``proben::roi_align_bwd``
and ``proben::nms_fixpoint``."""
