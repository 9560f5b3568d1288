# Hand-written Hopper kernels: fdp_gemm.py (wrappers, plain versions, build) +
# csrc/*.cu (the CUDA kernels, sharing csrc/fdp_common.cuh) + ops.py (public
# entry points) + ref.py.
