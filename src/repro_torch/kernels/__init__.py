"""Hand-written Hopper kernels, each beside its plain torch version."""


def plain_route(*tensors, interpret=None) -> bool:
    """True when a kernel's plain version must run: the caller asked for it
    (``interpret=True``), or the tensors lie on the CPU, where no CUDA
    kernel can launch. A CUDA tensor otherwise launches the kernel."""
    return bool(interpret) or all(t.device.type == "cpu" for t in tensors)
