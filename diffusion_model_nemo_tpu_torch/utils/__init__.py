from .image import decode_png, encode_png, to_uint8, to_uint8_tensor

__all__ = ["decode_png", "encode_png", "to_uint8", "to_uint8_tensor"]
