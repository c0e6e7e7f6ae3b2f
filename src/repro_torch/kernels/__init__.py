"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  extend_step     — K1, the fused expansion step (step_backend="pallas")
  candidate_mask  — K2, the candidate AND only (step_backend="jnp" with
                    use_pallas=True)
  popcount_reduce — K3, per-row popcount (domain sizes in the device
                    domain fixpoint)
  domain_ac       — K5 adjacency_any (one arc's support test, the batched
                    fixpoint) and K4 arc_any_sweep (every arc of a sweep,
                    the single-query fixpoint)

``ops`` holds the entry points (CUDA tensor → kernel, CPU tensor → plain
version, launch counts); ``ref`` the plain versions; ``_build`` compiles the
sources in ``src/repro_torch/csrc/`` with nvcc and binds them with ctypes.
"""
