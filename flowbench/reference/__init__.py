"""The benchmark's plain reference: float32 PyTorch models (memflow, on the
VideoFlow stack of mof), the plain padding and streaming around them, and
the lower-precision control.  Nothing here imports the program under
test."""
