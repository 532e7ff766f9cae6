"""The sharded serving plane (torch port of veneur_tpu/parallel/).

- `parallel.collectives`: the digest-home routing function, the stacked
  apply ops and the interval merges over the shard axis, as torch ops
- `parallel.sharded_server`: the ShardedServingPlane (topology,
  digest-home routing, `mesh.*`/`shard.*` telemetry)
- `parallel.reshard`: the elastic reshard, N -> M shards live, with a
  WAL-backed cutover and crash replay

Every shard lives on the store's own device: one card (or the CPU, when
the caller asks for it) holds all N shards. The JAX package's shard_map
dryrun path (`parallel/mesh.py`) is not ported.
"""
