"""PyTorch / CUDA port of gnumap_tpu for one NVIDIA H100.

The JAX package ``gnumap_tpu`` stays the reference: every module here is held
to its counterpart there (same names under ``align/``, ``pipeline/`` and
``cli/``).  This package imports ``torch``, never ``jax`` and nothing of
``gnumap_tpu``: it keeps its own copy of the numpy / C++ modules it needs
(config, core, index.builder and index.store, io, native, oracle,
align.scoring, posterior.snp, utils.sim), under the same names, and the tests
hold each copy to its original, so there is still one set of golden outputs.

Hand-written Hopper kernels live in ``csrc/`` and are built on first use by
``_build``; each has a plain PyTorch version beside its wrapper, which runs
for CPU tensors only.
"""
