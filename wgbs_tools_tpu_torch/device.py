"""Device selection and stage timing. There is no silent fallback: asking
for CUDA on a host without it raises."""

import sys

import torch

from . import trace


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


def timed(timings, stage, device, span=None):
    """Add the wall seconds of the block to timings[stage], and name the
    block in the profiler's trace.

    While a torch profiler runs, the block is the span `span` (see
    trace.py), by default `<module>.<stage>` after the calling module.
    With `timings` None nothing is timed and nothing synchronises.
    Otherwise the block ends with a synchronize of a CUDA `device`, so the
    seconds include the device work the block queued; a run measured this
    way waits for the device at the end of each device stage. Blocks on
    several host threads (bam2pat's chromosome threads) add their seconds
    into one sum."""
    if span is None and trace.on():
        module = sys._getframe(1).f_globals.get("__name__", "")
        span = f"{module.rpartition('.')[2]}.{stage}"
    return trace.stage(timings, stage, device, span)
