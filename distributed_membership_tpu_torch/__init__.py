"""PyTorch/CUDA port of the gossip membership simulator.

The JAX package ``distributed_membership_tpu`` is the reference; this
package mirrors its module names and reproduces its results bit for bit
on the slice it covers (the ``tpu_hash`` ring step under warm join), with
the Pallas kernels of that path rewritten as CUDA kernels (``csrc/``).
It imports neither JAX nor the JAX package.
"""
