"""The shard axis of the port's mesh paths: :mod:`.mesh` (S shards of a
mesh held on one device) and :mod:`.collectives` (the reductions and
exchanges over that axis)."""
