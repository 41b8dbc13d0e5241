# Hand-written Hopper kernels, each beside its plain PyTorch version:
# <name>/ref.py (plain), <name>/csrc/<name>.cu (kernel), <name>/ops.py (the
# wrapper that picks one by the tensors' device). build.py compiles every
# kernel with nvcc at first use.
