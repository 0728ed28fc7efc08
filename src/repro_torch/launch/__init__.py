"""Device meshes and the sharding rules over them (the reference's
``repro/launch/``): ``mesh`` builds a ``torch.distributed`` device mesh
with the reference's axis names, ``sharding`` holds the reference's
placement rules for parameters, optimizer state, inputs and decode caches,
as ``PartitionSpec``-like tuples, and turns them into DTensor
placements."""
