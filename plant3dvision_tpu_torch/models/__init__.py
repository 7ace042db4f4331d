"""Segmentation CNNs of the ML path (port of plant3dvision_tpu/models):
TPUSegNet and the ResUNet as torch `nn.Module`s, their forward programs,
the NPZ checkpoints with the flax <-> PyTorch weight carry-over, and their
training (train.py, train_synth.py, distill.py over optim.py)."""
