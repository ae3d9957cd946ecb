"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); it counts its launches in
`<wrapper>.launches`.

K1 denselookup.dense_lookup        csrc/dense_lookup.cu
K2 flashattn.flash_attention_fwd   csrc/flash_attention.cu
"""
