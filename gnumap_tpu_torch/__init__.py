"""PyTorch / CUDA port of gnumap_tpu for one NVIDIA H100.

The JAX package ``gnumap_tpu`` stays the reference: every module here is held
to its counterpart there (same names under ``align/``, ``pipeline/`` and
``cli/``).  This package imports ``torch`` and never ``jax``; it reuses the
numpy / C++ modules of ``gnumap_tpu`` (config, core, index.builder and
index.store, io, native, oracle, scoring, posterior/snp, utils/sim) so that
there is one oracle, one native host library and one set of golden outputs.

Hand-written Hopper kernels live in ``csrc/`` and are built on first use by
``_build``; each has a plain PyTorch version beside its wrapper, which runs
for CPU tensors only.
"""
