"""The port's hand-written CUDA kernels, their plain PyTorch versions
(``ref``) and the device-dispatching wrappers (``ops``)."""
from __future__ import annotations

from .decode import (codebook_decode_reduce_3d, codebook_decode_rows_3d, uniform_decode_reduce_3d,
                     uniform_decode_rows_3d)
from .encode_fused import (codebook_encode_pack_2d, codebook_encode_pack_resid_2d,
                           ef_correct_stats_2d, uniform_encode_pack_2d,
                           uniform_encode_pack_resid_2d)
from .orthogonalize import orthogonalize_2d
from .stats import bucket_stats_2d

#: every kernel wrapper; each counts its launches in ``.launches``
KERNELS = (ef_correct_stats_2d, bucket_stats_2d, codebook_encode_pack_resid_2d,
           codebook_decode_reduce_3d, uniform_encode_pack_resid_2d, uniform_decode_reduce_3d,
           codebook_encode_pack_2d, uniform_encode_pack_2d, codebook_decode_rows_3d,
           uniform_decode_rows_3d, orthogonalize_2d)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
