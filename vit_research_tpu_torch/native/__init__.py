"""Native host-runtime components (C, loaded via ctypes).

Port of vit_research_tpu/native: the libjpeg(-turbo) decoder with a
DCT-scaled decode fused with an exact-target bilinear resize
(``jpeg_fast.c``, the package's own copy of the reference's source),
compiled with ``cc`` at first use into the package's build directory.
ctypes releases the GIL during calls, so a thread pool decodes in
parallel. Where no compiler or libjpeg is present, ``is_available()`` is
False and callers use PIL, as in the reference.
"""

from vit_research_tpu_torch.native.jpeg import (  # noqa: F401
    decode_batch,
    decode_file,
    is_available,
    unavailable_reason,
)
