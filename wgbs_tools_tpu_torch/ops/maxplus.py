"""Max-plus closure of the fast segmentation DP's in-block edge matrices:
the CUDA kernel's wrapper and its plain PyTorch twin.

`maxplus_closure(S0, steps)` squares each (n, n) f32 matrix of S0
(nb, n, n) `steps` times in the (max, +) semiring,
S'[p, q] = max_r S[p, r] + S[r, q]. It replaces `closure` inside
wgbs_tools_tpu/models/segment.py::_dp_fast_blocked (:313-329), where S0 =
I (+) A of one block of B = 128 borders (n = 129) and steps =
ceil(log2 B) = 7. The kernel (csrc/maxplus.cu::maxplus_closure_kernel)
keeps one block's matrix on chip; the twin materializes the n^3 sums of a
slice of blocks at a time. max is exact and each sum is one IEEE rounding,
so the two agree bit for bit (the twin refuses +inf and NaN, which would
break that). A wrapper sends CUDA tensors to the kernel and CPU tensors to
the twin; any other device raises. `maxplus_closure.launches` counts its
launches.
"""

import torch

from .. import _kernels

NMAX = 144               # the kernel's largest matrix side
TWIN_ELEMS = 1 << 26     # (blocks, n, n, n) sums per twin slice (256 MB)


def _check(S0, steps):
    if (S0.dim() != 3 or S0.shape[1] != S0.shape[2]
            or S0.dtype != torch.float32 or not S0.is_contiguous()):
        raise ValueError(f"S0: got {S0.dtype} {tuple(S0.shape)} "
                         f"(contiguous={S0.is_contiguous()}), want a "
                         "contiguous torch.float32 (nb, n, n)")
    if not 1 <= S0.shape[1] <= NMAX:
        raise ValueError(f"n={S0.shape[1]} must be in [1, {NMAX}]")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")


def maxplus_closure(S0, steps):
    """S0 (nb, n, n) f32 squared `steps` times in the (max, +) semiring.

    Replaces the squarings of segment.py::_dp_fast_blocked's `closure`.
    CUDA tensors launch the kernel; CPU tensors take maxplus_closure_plain."""
    _check(S0, steps)
    if S0.device.type == "cpu":
        return maxplus_closure_plain(S0, steps)
    out = torch.empty_like(S0)
    nb, n, _ = S0.shape
    if nb == 0:
        return out
    _kernels.launch("maxplus_closure", S0.device, S0.data_ptr(),
                    out.data_ptr(), nb, n, int(steps))
    maxplus_closure.launches += 1
    return out


maxplus_closure.launches = 0


def maxplus_closure_plain(S0, steps):
    """Twin of the kernel in plain PyTorch: the JAX package's squaring,
    max over r of S[:, p, r, None] + S[:, None, r, q], on slices of blocks
    so that the (blocks, n, n, n) sums stay within TWIN_ELEMS."""
    _check(S0, steps)
    if torch.isnan(S0).any() or (S0 == float("inf")).any():
        raise ValueError("S0 holds NaN or +inf: the max-plus closure takes "
                         "finite values and -inf only")
    nb, n, _ = S0.shape
    out = S0.clone()
    per = max(1, TWIN_ELEMS // max(n ** 3, 1))
    for lo in range(0, nb, per):
        S = S0[lo:lo + per]
        for _ in range(steps):
            S = (S[:, :, :, None] + S[:, None, :, :]).amax(dim=2)
        out[lo:lo + per] = S
    return out
