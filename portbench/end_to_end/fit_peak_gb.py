"""The device memory the window's fits held at most
(``torch.cuda.max_memory_allocated`` reset at the window's start), in GB of
10^9 bytes."""


def read(ctx):
    return ctx.record["peak_bytes"] / 1e9
