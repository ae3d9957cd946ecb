"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); it counts its launches as
`kernels.<wrapper>.launches` in the tracing registry
(runtime/profiling.py).  Every entry refuses a gradient on both devices: a
backward through its result raises (`_nograd.refuses_gradient`), as the
TPU kernels cannot be differentiated either.

K1 denselookup.dense_lookup        csrc/dense_lookup.cu
K2 flashattn.flash_attention_fwd   csrc/flash_attention.cu
K3 flashcorr2.flash2_patch_level   csrc/corr_patch.cu
K4 denselookup.dense_patch_level   csrc/volume_patch.cu
K5 flashcorr.flash_patch_level     csrc/corr_patch.cu   (K3's function)
K6 bandlookup.band_patch_level     csrc/volume_patch.cu (K4's function)
K7 depthwise.depthwise_residual_gelu  csrc/depthwise.cu (no TPU kernel:
   PCBlock4's depthwise stages, which the JAX package left to XLA)
K8 pointwise.pointwise_gemm        csrc/pointwise_gemm.cu (no TPU kernel:
   PCBlock4's 1x1 convs with their adds and GELUs, left to XLA there too)
K9 memread.memory_read             csrc/memory_read.cu (no TPU kernel:
   MemFlow's memory reader, an XLA einsum chain in the JAX package)
"""
