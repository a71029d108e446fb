"""The benchmark of the PyTorch/CUDA port (`imagecaptioning_tpu_torch`):
see run.py."""
