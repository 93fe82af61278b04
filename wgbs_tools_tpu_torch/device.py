"""Device selection and stage timing. There is no silent fallback: asking
for CUDA on a host without it raises."""

import threading
import time
from contextlib import contextmanager

import torch

_TIMINGS_LOCK = threading.Lock()


def require_cuda():
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available (torch.cuda.is_available() is False); "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch path on the host")


def resolve_device(device):
    """'cuda', 'cuda:N', 'cpu' or a torch.device -> torch.device.

    A CUDA device raises when CUDA is absent; any other device type is
    rejected, since the port runs only on CUDA (kernels) or the CPU (their
    plain twins)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


@contextmanager
def timed(timings, stage, device):
    """Add the wall seconds of the block to timings[stage].

    A no-op when `timings` is None. Otherwise the block ends with a
    synchronize of a CUDA `device`, so the seconds include the device work
    the block queued; a run measured this way waits for the device at the
    end of each device stage. Blocks on several host threads (bam2pat's
    chromosome threads) add their seconds into one sum."""
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    with _TIMINGS_LOCK:
        timings[stage] = timings.get(stage, 0.0) + dt
