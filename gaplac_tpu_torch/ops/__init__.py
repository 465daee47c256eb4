"""Dense linear algebra and the hand-written CUDA kernels of the port."""
