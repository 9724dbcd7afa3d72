"""``python -m cald_tpu_torch.native``: build the JPEG decoder library and
print its path (exits non-zero with the compiler's message on failure)."""

import sys

from cald_tpu_torch.native import build

if __name__ == "__main__":
    try:
        print(build())
    except RuntimeError as e:
        sys.exit(str(e))
