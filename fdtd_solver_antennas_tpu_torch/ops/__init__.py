"""Engine: mesh, voxelizer, source, the Yee-step kernels and the run loop."""
