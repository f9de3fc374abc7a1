"""Hand-written CUDA kernels of the port, built with nvcc and bound with
ctypes (`build.py`); each sits beside its plain PyTorch version."""
