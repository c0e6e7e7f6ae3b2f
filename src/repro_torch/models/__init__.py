"""Models of the port (a port of ``repro.models``, dense LM serving only).

  common      — rms_norm, activations, the matmul in the activation dtype,
                the parameter initialiser
  attention   — RoPE, grouped decode attention over a KV cache, blockwise
                (online-softmax) attention
  transformer — the decoder-only LM: LMConfig, parameters, prefill (every
                layer's attention through K9 ``flash_attention``) and
                decode_step

MoE layers, windowed attention, training, and the GNN and recsys models are
not ported yet (ROADMAP Queue 1 item 14).
"""
