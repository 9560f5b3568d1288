# Hand-written Hopper kernels: fdp_gemm.py (wrapper, plain version, build) +
# csrc/fdp_gemm.cu (the CUDA kernel) + ops.py (public entry points) + ref.py.
