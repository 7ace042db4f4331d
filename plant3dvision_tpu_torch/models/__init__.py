"""Segmentation CNNs of the ML path (port of plant3dvision_tpu/models):
TPUSegNet as a torch `nn.Module`, its forward program, and the NPZ
checkpoint loader with the flax -> PyTorch weight carry-over."""
