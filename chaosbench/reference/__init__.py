"""The plain reference of each model family (``<family>.py``) and what they
share (``common.py``): float32 PyTorch with TF32 off, no kernels, no cache,
no remat. Nothing here imports the program, JAX or the JAX package.
"""
