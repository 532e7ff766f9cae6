"""The sharded serving plane over the local cards (torch port of
veneur_tpu/parallel/).

- `parallel.collectives`: the digest-home routing function, the stacked
  apply ops and the interval merges over the shard axis, each placement
  group reduced on its card and the partials on the store's, as torch
  ops
- `parallel.sharded_server`: the ShardedServingPlane (topology and
  placement over the cards, digest-home routing, `mesh.*`/`shard.*`
  telemetry)
- `parallel.reshard`: the elastic reshard, N -> M shards live, with a
  WAL-backed cutover and crash replay
- `parallel.mesh`: the multi-card dryrun, slots over the cards merged by
  copies between them

A sharded store places shard i on card i mod min(N, C) of the C visible
cards, or over the placement groups its caller names. Like the JAX
package's, this package __init__ imports none of its submodules.
"""
