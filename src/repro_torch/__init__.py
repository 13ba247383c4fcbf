"""PyTorch port of the ElfCore reproduction, for NVIDIA Hopper GPUs.

The package mirrors ``src/repro`` (the JAX reference) module for module so
each counterpart is easy to find: ``core/`` (sparsity, gating, the timestep
engine, the SNN layouts), ``kernels/<name>/{ref,ops,kernel}.py`` (plain
torch oracle, dispatch wrapper, hand-written GPU kernel), ``serving/`` (the
slot-multiplexed stream scheduler), ``launch/``, ``data/`` and ``obs/``.

It imports ``torch`` and never ``jax``, and nothing of ``repro``: whatever
it needs from a jax-free reference module is copied here. Entry points
default to ``device="cuda"``; tests pass ``device="cpu"``, where every
kernel wrapper runs its plain torch version.
"""
