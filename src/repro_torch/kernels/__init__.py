"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts the kernel
launches of each wrapper (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through them.
"""
LAUNCHES = {"spa_attention": 0, "paged_decode_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
