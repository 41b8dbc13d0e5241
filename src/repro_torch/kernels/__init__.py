# Hand-written Hopper kernels, each beside its plain PyTorch version:
# <name>/ref.py (plain), <name>/csrc/*.cu (kernel), <name>/build.py (nvcc),
# <name>/ops.py (the wrapper that picks one by the tensors' device).
