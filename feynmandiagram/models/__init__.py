"""Physics models: vectorized leaf kernels for the batched device evaluator.

The reference evaluates leaves one scalar at a time inside the MC loop
(example/benchmark.jl:61-87, Lehmann.Spectral kernels); here every kernel is
a jnp function over whole leaf/sample tensors, with derivative towers (for
renormalization counterterms) obtained by nested ``jax.grad`` of the stable
kernel instead of hand-coded formulas.
"""
from .free_fermion import green_kernel, green_derive_tower, TAU_CUTOFF
from .yukawa import yukawa_interaction, interaction_derive
