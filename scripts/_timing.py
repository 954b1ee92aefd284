"""Timing and comparison helpers of the port's kernel scripts on one NVIDIA
GPU (scripts/bench_k7_torch.py): CUDA-event medians, the card's name and
power limit, and the scale-free difference the kernels' checks gate on."""

import statistics
import subprocess

# H100 SXM: f32 FMA peak outside the tensor cores, dense tf32 tensor-core
# peak, HBM bandwidth
PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 494.7e12, 3.35e12


def cuda_ms(fn, runs=7):
    """Median milliseconds of fn() over ``runs`` timed runs after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def rel_err(got, want):
    """The largest difference of any pair of tensors over max(1, the largest
    entry of the second)."""
    return max((a.double() - b.double()).abs().max().item()
               / max(1.0, b.double().abs().max().item()) for a, b in zip(got, want))


def words_differ(got, want):
    """32-bit words that differ between two lists of f32 tensors, and of how many."""
    import torch

    bits = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(got, want))
    return bits, sum(a.numel() for a in got)
