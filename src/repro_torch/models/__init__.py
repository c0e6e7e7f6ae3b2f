"""Models of the port (a port of ``repro.models``).

  common      — rms_norm, activations, the matmul in the activation dtype,
                ``ParamSpec`` and the parameter initialisers
  attention   — RoPE, grouped decode attention over a KV cache, blockwise
                (online-softmax) attention, sliding-window attention
  moe         — top-k routing with group-local sort dispatch over the kept
                pairs, the expert FFN, the load-balance loss
  transformer — the decoder-only LM, dense or MoE: LMConfig, parameters,
                forward, the chunked loss (lm_loss, loss_fn), prefill
                (every layer's attention through K9 ``flash_attention``)
                and decode_step
  gnn         — message passing over edge lists (index ops, no kernel):
                GCN, GraphSAGE, SchNet, GraphCast, the neighbour sampler
  recsys      — embedding lookups and bags, DIN
"""
