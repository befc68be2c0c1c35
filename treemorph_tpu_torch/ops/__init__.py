"""Device ops of the port: voxelization, the submanifold-conv rulebook and
its gather engine, the band conv (a hand-written CUDA kernel), z-order
codes, and the host cylinder projection of the QSM stage."""
