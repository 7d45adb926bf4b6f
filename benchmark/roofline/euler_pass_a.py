"""Pass A of the 3D block march (``csrc/euler_pass_a.cu``): Green-Gauss
gradients of the 5 primitives, the JST sensor's two sums and, with the
dt bound, the wave-speed sums, a dimension at a time.

Bytes: each input and output byte once. It reads the state (5 channels)
and writes the gradients (15) and 6 sums, 9 with the dt bound, float32,
and reads each block's tables (16 float32 of geometry, 8 int32
neighbours). Operations: 80 a cell and dimension, 106 with the dt bound
(an add, mul, div, min/max, abs or sqrt each counts one)."""


def work(n_blocks: int, block_size: int, nd: int = 3,
         with_dt: bool = True):
    """(float32 operations, bytes) of one launch."""
    cells = n_blocks * block_size ** nd
    channels = 5 + 15 + (9 if with_dt else 6)
    return ((106 if with_dt else 80) * nd * cells,
            4 * channels * cells + (16 * 4 + 8 * 4) * n_blocks)
