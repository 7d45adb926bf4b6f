"""The fused RK2 stage of the 3D block march (``csrc/rk2_update.cu``):
the local time step from the wave-speed bound, the stage update in
conserved variables, back to guarded primitives.

Bytes: each input and output byte once. Stage 1 reads the state, R0 (5
channels each), the bound and the freeze mask (1 each) and writes the
state (5): 17 channels; stage 2 reads R1 too: 22. Operations: 62 a
cell."""


def work(n_cells: int, stage: int):
    """(float32 operations, bytes) of one launch of stage 1 or 2."""
    channels = 17 if stage == 1 else 22
    return 62 * n_cells, 4 * channels * n_cells
