"""The CUDA kernels K1 and K3, their build, and the canvas geometry."""
