"""Device operators: the CUDA kernels (`kernels`) and the channel-split
RHS and RK2 step around them (`rhs_cs`)."""
