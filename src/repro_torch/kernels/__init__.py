"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  extend_step     — K1, the fused expansion step (step_backend="pallas")
  candidate_mask  — K2, the candidate AND only (step_backend="jnp" with
                    use_pallas=True)
  popcount_reduce — K3, per-row popcount (domain sizes in the device
                    domain fixpoint)
  domain_ac       — K5 adjacency_any (the support tests of a sweep's live
                    (pattern, arc) pairs, the batched fixpoint), K4
                    arc_any_sweep (every arc of a sweep, the single-query
                    fixpoint), one kernel in csrc/arc_any.cuh; K8
                    csr_arc_sweep (the same sweep over CSR planes, the
                    sparse fixpoint)
  csr_extend      — K6 csr_extend and K7 csr_extend_bucketed, the sparse
                    expansion step (step_backend="csr" with use_pallas=True;
                    csr_walk="flat" / "bucketed")
  flash_attention — K9, causal attention forward (every layer of the LM
                    path's prefill, `repro_torch.models.transformer`)

``ops`` holds the entry points (CUDA tensor → kernel, CPU tensor → plain
version, launch counts); ``ref`` the plain versions; ``_build`` compiles the
sources in ``src/repro_torch/csrc/`` with nvcc and binds them with ctypes.
"""
