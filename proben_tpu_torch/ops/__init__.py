"""Tensor ops; ``stem_cuda``, ``roi_align_cuda``, ``epilogue_cuda`` and
``nms`` hold the CUDA kernels' wrappers and their plain versions. Importing
``stem_cuda``, ``roi_align_cuda`` and ``nms`` registers the
``torch.library`` custom ops ``proben::stem_pool``, ``proben::roi_align_fwd``,
``proben::roi_align_bwd``, ``proben::nms_keep`` and ``proben::nms_fixpoint``."""
