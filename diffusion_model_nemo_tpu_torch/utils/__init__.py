from .image import decode_png, encode_png, make_grid, save_image_grid, to_uint8, to_uint8_tensor

__all__ = ["decode_png", "encode_png", "make_grid", "save_image_grid", "to_uint8", "to_uint8_tensor"]
