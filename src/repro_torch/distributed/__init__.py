"""The distributed layer of the port (a port of ``repro.distributed``).

  shardings   — logical axes to ``PartitionSpec``s on a mesh, shard shapes
  compression — error-feedback int8 gradient compression

What a mesh, a sharding and a 512-device lowering become without a
compiler is settled in the design note at the top of
`repro_torch.launch.dryrun`.
"""
