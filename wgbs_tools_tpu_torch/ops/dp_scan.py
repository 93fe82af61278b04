"""The analysis step's serial segmentation DP: the CUDA kernel's wrapper and
its plain PyTorch twin.

`dp_scan(Crev, W)` runs one chain per row of Crev (nb, n, W) f32, cost rows
in ascending-k order (Crev[b, i, k] = cost(i - (W-1) + k, i)): M has
n + W + 1 slots, M[W] = 0 and the rest -inf; step i takes
cand[k] = M[i+1+k] + Crev[b, i, k], its first maximum am (ties to the
smaller k, the first NaN if there is one, 0 for a row of -inf: jnp.argmax's
order), writes M[W+i+1] = cand[am] and returns ks[b, i] = i - (W-1) + am,
int32 (nb, n). It replaces wgbs_tools_tpu/parallel/sharded.py::_dp_scan
(:105-122), a lax.scan with one dependent step per site. The kernel
(csrc/dp_scan.cu) has three bodies that its C entry picks by W alone
(dp_plan reports it): "push", where a step's dependent path is the
newest candidate's add and one max and every other candidate is pushed
into the steps that read it ahead of the chain (then a second kernel
takes each step's first maximum from M), and the first body's one warp
per chain with M's ring in shared memory ("warp") or in a global scratch
("warp global").
The twin (dp_scan_plain: the recurrence of models/segment.py::
_dp_fast_scan, all chains a step at a time) does the same IEEE f32 adds
and exact comparisons, so they agree bit for bit. A wrapper sends CUDA
tensors to the kernel and CPU tensors to the twin; any other device
raises. `dp_scan.launches` counts its launches.
"""

import ctypes

import torch

from .. import _kernels

BODIES = ("push", "warp", "warp global")  # csrc/dp_scan.cu's enum Body
NEG = float("-inf")


def dp_plan(n, W):
    """The launch dp_scan makes for n steps of width W, as its C entry
    chooses it (by W alone): {"body": one of BODIES, "scratch": floats of
    global scratch per chain (the push body's M, the warp global body's
    ring, else 0), "threads": per CTA, "smem": dynamic shared bytes}.
    Needs the kernel library, not the card."""
    out = (ctypes.c_int64 * 4)()
    _kernels.check(_kernels.load().dp_scan_plan(int(n), int(W), out),
                   "dp_scan_plan")
    return {"body": BODIES[out[0]], "scratch": out[1], "threads": out[2],
            "smem": out[3]}


def _check(Crev, W):
    if (Crev.dim() != 3 or Crev.dtype != torch.float32
            or not Crev.is_contiguous()):
        raise ValueError(f"Crev: got {Crev.dtype} {tuple(Crev.shape)} "
                         f"(contiguous={Crev.is_contiguous()}), want a "
                         "contiguous torch.float32 (nb, n, W)")
    if not 1 <= W <= 1 << 24 or Crev.shape[2] != W:
        raise ValueError(f"W={W}: want 1 <= W <= 2^24 and Crev's last axis "
                         f"({Crev.shape[2]}) equal to it")
    if Crev.shape[0] >= 1 << 31 or Crev.shape[1] >= 1 << 31:
        raise ValueError(f"Crev {tuple(Crev.shape)}: nb and n must be "
                         "below 2^31")


def dp_scan(Crev, W):
    """ks (nb, n) int32 of the chains Crev (nb, n, W) f32.

    Replaces sharded.py::_dp_scan. CUDA tensors launch the kernel (the body
    dp_plan(n, W) names), all chains in one call; CPU tensors take
    dp_scan_plain."""
    _check(Crev, W)
    if Crev.device.type == "cpu":
        return dp_scan_plain(Crev, W)
    nb, n, _ = Crev.shape
    ks = torch.empty((nb, n), dtype=torch.int32, device=Crev.device)
    if nb == 0 or n == 0:
        return ks
    _kernels.require_cuda("dp_scan", Crev.device)
    floats = dp_plan(n, W)["scratch"]
    scratch = (torch.empty((nb, floats), dtype=torch.float32,
                           device=Crev.device) if floats else None)
    _kernels.launch("dp_scan", Crev.device, Crev.data_ptr(), ks.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), nb, n,
                    W)
    dp_scan.launches += 1
    return ks


dp_scan.launches = 0


def dp_scan_plain(Crev, W):
    """Twin of the kernel in plain PyTorch: the recurrence of
    models/segment.py::_dp_fast_scan, every chain a step at a time on
    Crev's device; M[W+i+1] is cand[am] itself (JAX's cand[am])."""
    _check(Crev, W)
    nb, n, _ = Crev.shape
    dev = Crev.device
    Mpad = torch.full((nb, n + W + 1), NEG, dtype=torch.float32, device=dev)
    Mpad[:, W] = 0.0
    ams = torch.empty((nb, n), dtype=torch.int64, device=dev)
    for i in range(n):
        cand = Mpad[:, i + 1:i + 1 + W] + Crev[:, i]  # M[k], ascending k
        am = torch.argmax(cand, dim=-1)  # the first maximum, NaN first
        ams[:, i] = am
        Mpad[:, W + i + 1] = cand.gather(1, am[:, None])[:, 0]
    return (torch.arange(n, device=dev) - (W - 1) + ams).to(torch.int32)
