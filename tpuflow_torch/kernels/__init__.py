"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors and launches
its kernel for CUDA tensors (or raises); it counts its launches in
`<wrapper>.launches`.

K1 denselookup.dense_lookup        csrc/dense_lookup.cu
K2 flashattn.flash_attention_fwd   csrc/flash_attention.cu
K3 flashcorr2.flash2_patch_level   csrc/corr_patch.cu
K4 denselookup.dense_patch_level   csrc/volume_patch.cu
K5 flashcorr.flash_patch_level     csrc/corr_patch.cu   (K3's function)
K6 bandlookup.band_patch_level     csrc/volume_patch.cu (K4's function)
"""
