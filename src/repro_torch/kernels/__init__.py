"""The port's hand-written CUDA kernels, their plain PyTorch versions
(``ref``) and the device-dispatching wrappers (``ops``)."""
from __future__ import annotations

from . import quantize
from .decode import (codebook_decode_reduce_3d, codebook_decode_rows_3d, uniform_decode_reduce_3d,
                     uniform_decode_rows_3d)
from .encode_fused import (codebook_encode_pack_2d, codebook_encode_pack_resid_2d,
                           ef_correct_stats_2d, uniform_encode_pack_2d,
                           uniform_encode_pack_resid_2d)
from .orthogonalize import orthogonalize_2d
from .stats import bucket_stats_2d

#: every kernel wrapper, K1–K17 in ROADMAP Queue 2's order; each counts its
#: launches in ``.launches``
KERNELS = (ef_correct_stats_2d, codebook_encode_pack_resid_2d, uniform_encode_pack_resid_2d,
           codebook_decode_reduce_3d, uniform_decode_reduce_3d, codebook_encode_pack_2d,
           uniform_encode_pack_2d, codebook_decode_rows_3d, uniform_decode_rows_3d,
           bucket_stats_2d, orthogonalize_2d, quantize.uniform_encode_2d,
           quantize.uniform_decode_2d, quantize.codebook_encode_2d, quantize.codebook_decode_2d,
           quantize.uniform_encode_pack_2d, quantize.codebook_encode_pack_2d)


def kernel_name(kernel) -> str:
    """A kernel's key: its module and name (``encode_fused.uniform_encode_pack_2d``
    and ``quantize.uniform_encode_pack_2d`` are K7 and K16)."""
    return f"{kernel.__module__.rsplit('.', 1)[-1]}.{kernel.__name__}"


def launch_counts() -> dict[str, int]:
    return {kernel_name(k): k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
