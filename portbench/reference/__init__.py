"""The benchmark's yardstick: plain PyTorch references of what each cell
computes, the data-sheet peaks and the operation and byte counts the
roofline and ``mfu`` readers use. Nothing here imports the port, JAX or the
JAX package."""
