"""Sharding of the port over several devices (port of
``repro/distributed``): ``sharding.py``'s training section (the specs of
parameters, batches and dense caches over a data x model mesh) and its
serving section (one engine's heads, experts, FFN columns and SSM lane
rows over the shards of a serving mesh)."""
