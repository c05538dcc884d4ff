"""The plain-YOLOv8 baseline toolchain (counterpart of the JAX package's
``tools/cli``): :mod:`.train` trains the MGA-free graph with the segmentation
loss off through the port's trainer, :mod:`.val` validates its checkpoint
with the tapped neck outputs saved."""
