from .io import JpegCodec, compose_resize_pad, compose_resize_pad_plain, load_batch

__all__ = ["JpegCodec", "compose_resize_pad", "compose_resize_pad_plain", "load_batch"]
