"""rs-bann-tpu-torch: the PyTorch and CUDA port of rs_bann_tpu for NVIDIA Hopper.

Bayesian branch networks for genomic prediction: one small MLP per SNP group,
summed at the output, trained with Gibbs-within-MCMC (per-branch HMC over
weights and biases, conjugate Gibbs draws for every precision).

The package mirrors rs_bann_tpu's layout (ops/, models/, samplers/, io/,
cli/, train.py) and keeps its stacked, padded [G, ...] tensor layouts, so
each function can be held against its JAX counterpart. It imports torch and
never jax. The kernels the JAX package wrote in Pallas are hand-written CUDA
for sm_90a under csrc/, built with nvcc on first use (ops/_build.py).

This slice covers the packed-genotype ``train-new`` -> ``predict`` path with
the sequential schedule.
"""

__version__ = "0.1.0"
