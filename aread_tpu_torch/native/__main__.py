"""``python -m aread_tpu_torch.native``: build the native CSV parser now
and print the library's path."""

from aread_tpu_torch.native import build

print("native library:", build())
