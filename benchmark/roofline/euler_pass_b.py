"""Pass B of the 3D block march (``csrc/euler_pass_b.cu``): MUSCL faces
blended by the JST sensor, HLL fluxes and their Green-Gauss sum into the
residual.

Bytes: each input and output byte once. It reads the state (5 channels),
the gradients (15) and the sensor (1), writes the residual (5), float32,
and reads each block's tables (16 float32, 8 int32). Operations a cell
and dimension: one face of 281 (MUSCL and blend 37 a channel, HLL sides
44, flux 50) plus the block's far edge face, 281 / bs, plus 25 to mask
and accumulate."""


def work(n_blocks: int, block_size: int, nd: int = 3):
    """(float32 operations, bytes) of one launch."""
    cells = n_blocks * block_size ** nd
    ops = nd * (281 + 281 / block_size + 25) * cells
    return ops, 4 * (5 + 15 + 1 + 5) * cells + (16 * 4 + 8 * 4) * n_blocks
