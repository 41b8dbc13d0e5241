# The paper's method in PyTorch: interpolants, solvers and the mixed-type
# schema. The composable API lives in repro_torch.tabgen.
