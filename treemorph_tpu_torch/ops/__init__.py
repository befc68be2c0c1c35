"""Device ops of the port: voxelization, the submanifold-conv rulebook and
its gather engine, the band and z-band convs and the brick conv
(hand-written CUDA kernels) with the brick layout, window attention,
z-order and Hilbert codes, PointNet++'s sampling and grouping, and the
host cylinder projection of the QSM stage."""
