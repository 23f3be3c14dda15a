"""posecnn_tpu — a 6D object pose estimation framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the PoseCNN pipeline
(semantic labeling + center-direction Hough voting + quaternion
regression with ADD/ADD-S loss + depth-based ICP refinement): SPMD
over device meshes, functional transforms, static shapes, and Pallas
kernels where XLA's own code is far from the hardware's limit.

Capability parity target: mrlooi/PoseCNN (see SURVEY.md). This is not
a port — the reference's TF1/CUDA architecture is replaced by an
idiomatic JAX design.
"""

__version__ = "0.1.0"
