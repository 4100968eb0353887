"""Deployment export (counterpart of ``proben_tpu/export/``). Importing it
registers the kernels' ``torch.library`` custom ops, so a loaded program
runs without the model-building code."""

from .api import export_model, load_exported

__all__ = ["export_model", "load_exported"]
