"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts the kernel
launches of each wrapper (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through them.
"""
import threading

LAUNCHES = {"spa_attention": 0, "spa_attention_bwd": 0,
            "paged_decode_attention": 0, "paged_verify_attention": 0,
            "paged_mla_decode_attention": 0,
            "paged_mla_verify_attention": 0, "transfer_cast": 0}
# the rollout producer threads and the trainer launch kernels concurrently;
# ``d[k] += 1`` is not atomic across threads, so counts go through the lock
_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
