"""Hand-written CUDA kernels for Hopper and their build.

Nothing here imports or builds anything CUDA-side at import time: the first
kernel render of a scene structure runs ``nvcc`` (see ``build.py``)."""
