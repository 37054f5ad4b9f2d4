"""PyTorch + CUDA port of the PMT stereo segmentation + disparity system for
NVIDIA Hopper (H100). The JAX package beside it is the reference; this
package imports neither it nor JAX. Entry points run on the card unless the
caller passes ``device="cpu"``."""
