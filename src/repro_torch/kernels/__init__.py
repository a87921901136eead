"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts the kernel
launches of each wrapper (incremented where the kernel is launched and
nowhere else), so a run can show that its main path went through them.

A wrapper called while a CUDA graph is being captured does not launch:
its kernel becomes a node of the graph, which launches it at every
replay. So on the capturing thread ``count_launch`` adds to the graph's
tally (``recording``) instead, and each replay adds the whole tally to
``LAUNCHES`` (``add_launches``).
"""
import contextlib
import threading

LAUNCHES = {"spa_attention": 0, "spa_attention_bwd": 0,
            "paged_decode_attention": 0, "paged_verify_attention": 0,
            "paged_mla_decode_attention": 0,
            "paged_mla_verify_attention": 0, "transfer_cast": 0,
            # the contiguous-cache wrappers, which launch the paged
            # kernels on a one-page-per-row view
            "decode_attention": 0, "verify_attention": 0,
            "mla_decode_attention": 0, "mla_verify_attention": 0}
# the rollout producer threads and the trainer launch kernels concurrently;
# ``d[k] += 1`` is not atomic across threads, so counts go through the lock
_lock = threading.Lock()
# the tally of the graph this thread is capturing (other threads' launches
# during a capture are eager and count as such)
_capture = threading.local()


def count_launch(name: str) -> None:
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _lock:
        LAUNCHES[name] += 1


def add_launches(tally: dict) -> None:
    """One replay of a captured graph: every kernel it holds, launched."""
    with _lock:
        for name, n in tally.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def recording():
    """Yield the dict that collects this thread's ``count_launch`` calls
    while a graph is captured."""
    tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
